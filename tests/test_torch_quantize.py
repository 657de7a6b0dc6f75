"""The port's replay codecs (`actor_critic_tpu_torch/replay/quantize.py`)
against the JAX package's (`actor_critic_tpu/replay/quantize.py`), on the
same numpy inputs, each JAX function jitted as the trainers run it:

- `encode` for every kind, bit for bit, NaN and ±1e6 saturation included;
- `decode` bit for bit for `raw`, `f16`, `bool8` and `i8_unit`; `i8`
  within one ulp, the mismatches counted: XLA contracts `q·(s/127) + m`
  into a fused multiply-add on some lanes of its vectorised loop and not
  on others (by column), and the port fuses every lane;
- `update_stats` across the 4,096-transition calibration freeze (the
  count bit for bit, mean and scale within 1e-6 relative, their bitwise
  mismatches counted);
- `offpolicy_codecs`, `default_codecs`, `storage_dtype`, `init_stats` for
  each mode and kind, and `capacity_report` of a ring in each mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.replay import buffer as jbuffer
from actor_critic_tpu.replay import quantize as jq
from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.replay import buffer as tbuffer
from actor_critic_tpu_torch.replay import quantize as tq

JNP_OF = {torch.float32: jnp.float32, torch.float16: jnp.float16, torch.int8: jnp.int8,
          torch.uint8: jnp.uint8}


def _t_stats(stats) -> tq.QuantStats:
    return tq.QuantStats(*(torch.from_numpy(np.array(x)) for x in stats))


def _j_stats(stats: tq.QuantStats):
    return jq.QuantStats(jnp.asarray(stats.mean.numpy()), jnp.asarray(stats.scale.numpy()),
                         jnp.asarray(int(stats.count), jnp.int32))


def _inputs(kind, seed, shape=(257, 3)):
    rng = np.random.default_rng(seed)
    if kind == "bool8":
        x = (rng.random(shape) < 0.3).astype(np.float32)
        x.flat[[0, 1, 2, 3]] = [np.nan, 1e6, -1e6, 0.5]
    elif kind == "i8_unit":
        x = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
        x.flat[[0, 1, 2, 3]] = [np.nan, 1e6, -1e6, 0.0]
    else:
        x = (rng.standard_normal(shape) * 3.0 + 1.0).astype(np.float32)
        x.flat[[0, 1, 2, 3, 4]] = [np.nan, 1e6, -1e6, np.inf, -np.inf]
    mean = rng.standard_normal(shape[1:]).astype(np.float32)
    scale = (np.abs(rng.standard_normal(shape[1:])) * 2.0 + 0.1).astype(np.float32)
    stats = jq.QuantStats(jnp.asarray(mean), jnp.asarray(scale), jnp.asarray(5000, jnp.int32))
    return x, stats


@pytest.mark.parametrize("kind", jq.KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_is_bitwise_jax(kind, seed):
    x, jstats = _inputs(kind, seed)
    jdtype = jq.storage_dtype(kind, jnp.float32)
    want = np.asarray(jax.jit(lambda x, s: jq.encode(kind, s, x, jdtype))(x, jstats))
    tdtype = tq.storage_dtype(kind, torch.float32)
    got = tq.encode(kind, _t_stats(jstats), torch.from_numpy(x), tdtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if kind in ("i8", "i8_unit", "bool8"):
        # Saturating: NaN narrows to the midpoint, ±1e6 to the ends.
        lo = 0 if kind == "bool8" else -127
        assert got.flat[0] == (0 if kind != "i8" else want.flat[0])
        assert got.flat[1] == (1 if kind == "bool8" else 127) and got.flat[2] == lo


@pytest.mark.parametrize("kind", jq.KINDS)
def test_decode_matches_jax(kind):
    rng = np.random.default_rng(3)
    _, jstats = _inputs("i8", 3, shape=(4096, 3))
    if kind == "raw":
        q = rng.standard_normal((4096, 3)).astype(np.float32)
    elif kind == "f16":
        q = rng.standard_normal((4096, 3)).astype(np.float16)
    elif kind == "bool8":
        q = rng.integers(0, 2, (4096, 3)).astype(np.int8)
    else:
        q = rng.integers(-127, 128, (4096, 3)).astype(np.int8)
    want = np.asarray(jax.jit(lambda q, s: jq.decode(kind, s, q))(q, jstats))
    got = tq.decode(kind, _t_stats(jstats), torch.from_numpy(q)).numpy()
    assert got.dtype == want.dtype
    if kind != "i8":
        np.testing.assert_array_equal(got, want)
        return
    # One fused multiply-add against XLA's mix of fused and unfused lanes:
    # every element is one of the two roundings, within one ulp.
    stats = _t_stats(jstats)
    unfused = (torch.from_numpy(q).float() * (stats.scale * tq._INV_127) + stats.mean).numpy()
    assert np.all((got == want) | (unfused == want))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    mismatches = int((got != want).sum())
    assert mismatches < want.size // 4, mismatches


def test_i8_roundtrip_error_is_within_a_step():
    x, jstats = _inputs("i8", 4, shape=(512, 3))
    x = np.clip(np.nan_to_num(x), -2.0, 4.0)
    stats = tq.QuantStats(torch.full((3,), 1.0), torch.full((3,), 3.0), torch.tensor(0))
    back = tq.decode("i8", stats, tq.encode("i8", stats, torch.from_numpy(x), torch.int8))
    assert float((back - torch.from_numpy(x)).abs().max()) <= 3.0 / 127 / 2 + 1e-6


@pytest.mark.parametrize("item_shape", [(3,), ()])
def test_update_stats_across_the_calibration_freeze(item_shape):
    """Batches of 1,000 folded in from zeroed stats: the mean and scale move
    until the count reaches 4,096 (the fifth batch is the first refused),
    then freeze; the count saturates only at 2^30."""
    rng = np.random.default_rng(5)
    jstats = jq.init_stats("i8", jnp.zeros(item_shape, jnp.float32))
    tstats = tq.init_stats("i8", torch.zeros(item_shape))
    jstep = jax.jit(lambda s, b: jq.update_stats("i8", s, b))
    mismatches = 0
    for i in range(7):
        batch = (rng.standard_normal((1000, *item_shape)) * (1 + i) + i).astype(np.float32)
        before = tstats
        jstats = jstep(jstats, batch)
        tstats = tq.update_stats("i8", tstats, torch.from_numpy(batch))
        assert int(tstats.count) == int(jstats.count) == 1000 * (i + 1)
        for name in ("mean", "scale"):
            got, want = getattr(tstats, name).numpy(), np.asarray(getattr(jstats, name))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            mismatches += int((got != want).sum())
        frozen = i >= 5  # counts 5,000 and 6,000 were past calibration
        assert torch.equal(tstats.mean, before.mean) == frozen
    # The batch mean is a sum taken in another order by XLA; what differs
    # is the last bits, and only there.
    assert mismatches <= 2 * 7 * max(1, int(np.prod(item_shape))), mismatches
    # Stat-free kinds pass the stats through.
    other = tq.init_stats("raw", torch.zeros(3))
    assert tq.update_stats("raw", other, torch.ones(4, 3)) is other


def test_update_stats_scale_floor_and_count_saturation():
    stats = tq.QuantStats(torch.zeros(2), torch.full((2,), 1e-6), torch.tensor((1 << 30) - 3))
    out = tq.update_stats("i8", stats, torch.zeros(8, 2))
    assert int(out.count) == 1 << 30
    assert torch.equal(out.scale, torch.full((2,), 1e-6, dtype=torch.float32))
    jout = jq.update_stats("i8", _j_stats(stats), jnp.zeros((8, 2), jnp.float32))
    assert int(jout.count) == int(out.count)


@pytest.mark.parametrize("mode", jq.MODES)
def test_offpolicy_codecs_match_jax(mode):
    got, want = tq.offpolicy_codecs(mode), jq.offpolicy_codecs(mode)
    assert tuple(got) == tuple(want) and got._fields == want._fields
    for kind in set(got):
        for tdtype in (torch.float32, torch.uint8):
            jdtype = jq.storage_dtype(kind, JNP_OF[tdtype])
            assert JNP_OF[tq.storage_dtype(kind, tdtype)] == jdtype
        js = jq.init_stats(kind, jnp.zeros((3,), jnp.float32))
        ts = tq.init_stats(kind, torch.zeros(3))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="replay_dtype"):
        tq.offpolicy_codecs("bf16")
    with pytest.raises(ValueError, match="unknown codec"):
        tq.storage_dtype("i4", torch.float32)
    assert tq.default_codecs((torch.zeros(1), (torch.zeros(2),))) == ("raw", ("raw",))


@pytest.mark.parametrize("mode", jq.MODES)
def test_capacity_report_matches_jax(mode):
    obs_dim, act_dim, cap = 17, 6, 64
    example = dict(obs=np.zeros(obs_dim, np.float32), action=np.zeros(act_dim, np.float32),
                   reward=np.float32(0), next_obs=np.zeros(obs_dim, np.float32),
                   terminated=np.float32(0), done=np.float32(0))
    from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition

    jring = jbuffer.init(JTransition(**{k: jnp.asarray(v) for k, v in example.items()}), cap,
                         jq.offpolicy_codecs(mode))
    tring = tbuffer.init(OffPolicyTransition(**{k: torch.from_numpy(np.asarray(v))
                                                for k, v in example.items()}),
                         cap, tq.offpolicy_codecs(mode))
    want = jq.capacity_report(jring, jq.offpolicy_codecs(mode))
    assert tq.capacity_report(tring, tq.offpolicy_codecs(mode)) == want
    if mode == "mixed":
        # obs, next_obs, reward int8; done flags int8; actions fp32.
        assert want["bytes_per_transition"] == 2 * obs_dim + 1 + 2 + 4 * act_dim
