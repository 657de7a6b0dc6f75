"""The port's replay ring (`actor_critic_tpu_torch/replay/buffer.py`) against
the JAX package's (`actor_critic_tpu/replay/buffer.py`), on the same numpy
transitions:

- `init` and `add_batch` across the wrap and with a batch larger than the
  ring: every storage leaf, `insert_pos` and `size` equal to JAX's (bit for
  bit in `fp32`; in `mixed` and `int8` the codes within one step, the
  stats' last bits coming from a sum taken in another order);
- `sample` and `sample_sequences`: JAX's ring is filled with each slot's
  own index as `obs`, so the `obs` JAX returns names the slots it drew;
  the port, given those slots (for windows, the starts counted from the
  oldest entry), returns every leaf equal to JAX's;
- the defaulted-codec guard;
- the index draw: its range, and a χ² test of its uniformity;
- the ring is written in place: every storage leaf, the cursor, the count
  and every stat keep their storage across inserts and samples, through
  the codecs (what a CUDA graph of the step relies on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition
from actor_critic_tpu.replay import buffer as jbuffer
from actor_critic_tpu.replay import quantize as jq
from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.replay import buffer as tbuffer
from actor_critic_tpu_torch.replay import quantize as tq
from actor_critic_tpu_torch.tree import named_leaves, tree_leaves

OBS, ACT = 3, 2


def _example_np():
    return dict(obs=np.zeros(OBS, np.float32), action=np.zeros(ACT, np.float32),
                reward=np.float32(0), next_obs=np.zeros(OBS, np.float32),
                terminated=np.float32(0), done=np.float32(0))


def _rings(capacity, mode):
    ex = _example_np()
    jring = jbuffer.init(JTransition(**{k: jnp.asarray(v) for k, v in ex.items()}), capacity,
                         jq.offpolicy_codecs(mode))
    tring = tbuffer.init(OffPolicyTransition(**{k: torch.from_numpy(np.asarray(v))
                                                for k, v in ex.items()}),
                         capacity, tq.offpolicy_codecs(mode))
    return jring, tring


def _batch_np(b, seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=(rng.standard_normal((b, OBS)) * 2).astype(np.float32),
        action=rng.uniform(-1, 1, (b, ACT)).astype(np.float32),
        reward=rng.standard_normal(b).astype(np.float32),
        next_obs=(rng.standard_normal((b, OBS)) * 2).astype(np.float32),
        terminated=(rng.random(b) < 0.1).astype(np.float32),
        done=(rng.random(b) < 0.2).astype(np.float32),
    )


def _j(batch):
    return JTransition(**{k: jnp.asarray(v) for k, v in batch.items()})


def _t(batch):
    return OffPolicyTransition(**{k: torch.from_numpy(v) for k, v in batch.items()})


def _compare_rings(jring, tring, mode):
    assert int(tring.insert_pos) == int(jring.insert_pos)
    assert int(tring.size) == int(jring.size)
    for (name, got), want in zip(named_leaves(tring.storage).items(), jax.tree.leaves(jring.storage)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, name
        if mode == "fp32" or got.dtype != torch.int8:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            # An `i8` code sits on a rounding boundary where the stats'
            # last bit differs: one step at most, and rarely.
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (name, diff.max())
    for (name, got), want in zip(named_leaves(tring.quant).items(), jax.tree.leaves(jring.quant)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("mode", jq.MODES)
def test_add_batch_across_the_wrap_matches_jax(mode):
    """Capacity 40: batches of 16, 16, 16 (the third straddles the wrap),
    then 100 > capacity (only its newest 40 rows land)."""
    jring, tring = _rings(40, mode)
    codecs_j, codecs_t = jq.offpolicy_codecs(mode), tq.offpolicy_codecs(mode)
    add = jax.jit(lambda r, b: jbuffer.add_batch(r, b, codecs_j))
    for i, b in enumerate((16, 16, 16, 100)):
        batch = _batch_np(b, seed=i)
        jring = add(jring, _j(batch))
        tbuffer.add_batch(tring, _t(batch), codecs_t)
        _compare_rings(jring, tring, mode)
    assert int(tring.size) == 40 and int(tring.insert_pos) == (48 + 40) % 40


def test_init_shapes_dtypes_and_capacity():
    _, tring = _rings(8, "int8")
    assert tbuffer.capacity_of(tring) == 8
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in named_leaves(tring.storage).items()}
    assert shapes == {"obs": ((8, OBS), torch.int8), "action": ((8, ACT), torch.int8),
                      "reward": ((8,), torch.int8), "next_obs": ((8, OBS), torch.int8),
                      "terminated": ((8,), torch.int8), "done": ((8,), torch.int8)}
    assert tring.quant.obs.mean.shape == (OBS,) and tring.quant.action.mean.shape == ()
    assert tring.size.dtype == tring.insert_pos.dtype == torch.int64


def _index_rings(capacity, n_inserts):
    """A JAX and a port fp32 ring after `n_inserts` transitions whose `obs`
    is (insert index, slot, 0) and whose other leaves are random."""
    jring, tring = _rings(capacity, "fp32")
    codecs_j, codecs_t = jq.offpolicy_codecs("fp32"), tq.offpolicy_codecs("fp32")
    done = 0
    seed = 0
    while done < n_inserts:
        b = min(7, n_inserts - done)
        batch = _batch_np(b, seed=seed)
        ids = np.arange(done, done + b)
        batch["obs"] = np.stack([ids, ids % capacity, np.zeros(b)], axis=1).astype(np.float32)
        jring = jbuffer.add_batch(jring, _j(batch), codecs_j)
        tbuffer.add_batch(tring, _t(batch), codecs_t)
        done += b
        seed += 1
    return jring, tring


@pytest.mark.parametrize("capacity,n_inserts", [(64, 40), (64, 150)])
def test_sample_at_jax_slots_matches_jax(capacity, n_inserts):
    jring, tring = _index_rings(capacity, n_inserts)
    codecs_j, codecs_t = jq.offpolicy_codecs("fp32"), tq.offpolicy_codecs("fp32")
    want = jbuffer.sample(jring, jax.random.key(3), 128, codecs_j)
    slots = torch.from_numpy(np.asarray(want.obs[:, 1]).astype(np.int64))
    assert int(slots.max()) < min(capacity, n_inserts)
    got = tbuffer.sample_at(tring, slots, codecs_t)
    for name, leaf in named_leaves(got).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("capacity,n_inserts", [(64, 40), (64, 64), (64, 150)])
def test_sample_sequences_at_jax_starts_matches_jax(capacity, n_inserts):
    """Windows of 5 consecutive inserts; past the wrap (150 inserts into
    64) a window may straddle slot 63 → 0 but never the write cursor."""
    jring, tring = _index_rings(capacity, n_inserts)
    codecs_j, codecs_t = jq.offpolicy_codecs("fp32"), tq.offpolicy_codecs("fp32")
    want = jbuffer.sample_sequences(jring, jax.random.key(4), 96, 5, codecs_j)
    ids = np.asarray(want.obs[:, :, 0]).astype(np.int64)
    assert np.all(np.diff(ids, axis=1) == 1)  # consecutive inserts, no seam
    oldest = int(tbuffer.oldest_slot(tring))
    starts = torch.from_numpy((np.asarray(want.obs[:, 0, 1]).astype(np.int64) - oldest) % capacity)
    got = tbuffer.sequences_at(tring, starts, 5, codecs_t)
    for name, leaf in named_leaves(got).items():
        assert leaf.shape[:2] == (96, 5)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # The port's own draw keeps the contract too.
    own = tbuffer.sample_sequences(tring, torch.Generator().manual_seed(0), 256, 5, codecs_t)
    own_ids = own.obs[:, :, 0].numpy().astype(np.int64)
    assert np.all(np.diff(own_ids, axis=1) == 1)
    assert own_ids.min() >= n_inserts - min(capacity, n_inserts)


def test_defaulted_codecs_guard():
    _, tring = _rings(8, "mixed")
    with pytest.raises(ValueError, match="quantized storage"):
        tbuffer.add_batch(tring, _t(_batch_np(2, 0)))
    with pytest.raises(ValueError, match="quantized storage"):
        tbuffer.sample(tring, torch.Generator().manual_seed(0), 4)
    with pytest.raises(ValueError, match="quantized storage"):
        tbuffer.sample_sequences(tring, torch.Generator().manual_seed(0), 4, 2)
    # An explicit all-raw spec is a raw int8 ring, as the guard says.
    raw = tq.default_codecs(tring.storage)
    tbuffer.sample(tring, torch.Generator().manual_seed(0), 4, raw)
    _, fp32 = _rings(8, "fp32")
    tbuffer.add_batch(fp32, _t(_batch_np(2, 0)))  # nothing quantized: the default is fine


def test_index_draw_range_and_uniformity():
    g = torch.Generator().manual_seed(11)
    for bound in (1, 2, 7, 1000, 1_000_000):
        idx = tbuffer.draw_indices(g, 4096, torch.tensor(bound))
        assert idx.dtype == torch.int64 and int(idx.min()) >= 0 and int(idx.max()) < bound
    assert int(tbuffer.draw_indices(g, 16, torch.tensor(0)).max()) == 0  # empty: slot 0
    # χ² over 50 slots from 200,000 draws: 49 degrees of freedom, the 0.999
    # quantile is 85.35.
    n, k = 200_000, 50
    counts = torch.bincount(tbuffer.draw_indices(g, n, torch.tensor(k)), minlength=k).double()
    chi2 = float(((counts - n / k) ** 2 / (n / k)).sum())
    assert chi2 < 85.35, chi2


@pytest.mark.parametrize("mode", jq.MODES)
def test_ring_is_written_in_place(mode):
    _, tring = _rings(32, mode)
    codecs = tq.offpolicy_codecs(mode)
    leaves = tree_leaves(tring)
    ptrs = [t.data_ptr() for t in leaves]
    before = [t.clone() for t in leaves]
    g = torch.Generator().manual_seed(0)
    for i in range(6):  # 6 × 10 inserts: wraps the 32 slots
        tbuffer.add_batch(tring, _t(_batch_np(10, seed=i)), codecs)
        tbuffer.sample(tring, g, 8, codecs)
        tbuffer.sample_sequences(tring, g, 8, 3, codecs)
        assert [t.data_ptr() for t in tree_leaves(tring)] == ptrs
    changed = [not torch.equal(a, b) for a, b in zip(tree_leaves(tring), before)]
    storage_n = len(tree_leaves(tring.storage))
    assert all(changed[:storage_n + 2])  # every storage leaf, the cursor, the count
    if mode != "fp32":
        # The `i8` leaves' stats moved, in their own storage.
        assert tring.quant.obs.count.item() == 60
        assert bool(tring.quant.obs.mean.ne(0).all()) and bool(tring.quant.reward.scale.gt(1e-6))
