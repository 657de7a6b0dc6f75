"""The port's device data plane (`actor_critic_tpu_torch/data_plane/`) on
the CPU, against the JAX package's `data_plane/` and its tests
(tests/test_data_plane.py): the ring's bookkeeping (TrajQueue's drop-oldest
and staleness semantics), codec round trips through the ring, the numpy
codecs against JAX's bit for bit (stats, encode, decode), the ring's torch
decode against the numpy mirror exactly, the checkpoint's stats round trip,
the off-policy device ingest against JAX's replay ring after the same
blocks, the slot poisoner on both planes, and the R2D2-style sequence
consumer against JAX's. The JAX-only AOT / compile-plan cases and
run_report are left out (they have no counterpart yet)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu import replay as jreplay
from actor_critic_tpu.algos import ddpg as jddpg
from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition
from actor_critic_tpu.data_plane import codecs as jcodecs
from actor_critic_tpu.data_plane import device_replay as jdevice_replay
from actor_critic_tpu_torch import replay
from actor_critic_tpu_torch.algos import ddpg as tddpg
from actor_critic_tpu_torch.algos import host_loop, ppo
from actor_critic_tpu_torch.algos import traj_queue
from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.data_plane import codecs as np_codecs
from actor_critic_tpu_torch.data_plane import device_replay
from actor_critic_tpu_torch.data_plane import ring as dp_ring
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from actor_critic_tpu_torch.replay import quantize
from torch_offpolicy_states import load_learner

S = dp_ring.array_spec


def _ring(depth=2, codec="fp32", spec=None, **kw):
    return dp_ring.DeviceTrajRing(depth=depth, block_spec=spec or {"x": S((3, 2), "float32")},
                                  codec=codec, **kw)


def _slot(ring, lease, name="x"):
    return ring.state.storage[name][lease.slot].numpy()


def _decoded(ring, lease):
    ring.select(lease)
    return {k: v.numpy() for k, v in
            dp_ring.gather_block(ring.state, ring.slot_index, ring.codecs).items()}


class TestRingBookkeeping:
    def test_init_shapes_and_codec_mix(self):
        spec = {"obs": S((4, 2, 3), "float32"), "action": S((4, 2), "int64"),
                "done": S((4, 2), "float32"), "log_prob": S((4, 2), "float32")}
        ring = dp_ring.DeviceTrajRing(depth=3, block_spec=spec, codec="int8")
        st = ring.state
        assert st.storage["obs"].shape == (3, 4, 2, 3)
        assert st.storage["obs"].dtype == torch.int8       # obs family: i8
        assert st.storage["done"].dtype == torch.int8      # bool8
        assert st.storage["log_prob"].dtype == torch.float32  # always raw
        assert st.storage["action"].dtype == torch.int64   # raw, its own dtype
        assert st.versions.shape == st.seqs.shape == (3,)
        assert (st.versions == -1).all() and (st.seqs == -1).all()
        assert "obs:i8" in ring.codec_mix()
        assert ring.bytes_per_block() < ring.raw_bytes_per_block()
        # JAX's ring picks the same kinds.
        jspec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in spec.items()}
        assert ring.codecs == jcodecs.traj_codecs("int8", jspec)

    def test_put_get_release_cycle(self):
        ring = _ring(depth=2)
        a = np.full((3, 2), 7.0, np.float32)
        assert ring.put({"x": a}, version=0, actor_id=1)
        lease = ring.get(timeout=1.0)
        assert (lease.version, lease.actor_id, lease.seq) == (0, 1, 0)
        np.testing.assert_array_equal(_slot(ring, lease), a)
        a.fill(-1.0)  # the ring copied at the encode
        np.testing.assert_array_equal(_slot(ring, lease), 7.0)
        ring.release(lease)
        assert ring.get(timeout=0) is None

    def test_device_version_tree_mirrors_host_bookkeeping(self):
        ring = _ring(depth=2)
        for v in range(2):
            ring.put({"x": np.full((3, 2), float(v), np.float32)}, version=v + 5)
        st = ring.state
        assert sorted(st.versions.tolist()) == [5, 6]
        assert sorted(st.seqs.tolist()) == [0, 1]
        assert ring.stats()["puts"] == 2

    def test_drop_oldest_backpressure(self):
        ring = _ring(depth=2)
        for v in range(4):  # 2 slots, 4 puts: the two oldest dropped
            assert ring.put({"x": np.full((3, 2), float(v), np.float32)}, version=v)
        assert ring.stats()["drops_full"] == 2
        lease = ring.get(timeout=1.0)
        assert lease.version == 2  # the oldest SURVIVING block
        np.testing.assert_array_equal(_slot(ring, lease), 2.0)

    def test_drop_oldest_never_reclaims_leased_slot(self):
        ring = _ring(depth=1)
        assert ring.put({"x": np.zeros((3, 2), np.float32)}, version=0)
        lease = ring.get(timeout=1.0)
        # The single slot is leased: a put waits, it does not overwrite.
        assert not ring.put({"x": np.ones((3, 2), np.float32)}, version=1, timeout=0.05)
        np.testing.assert_array_equal(_slot(ring, lease), 0.0)
        ring.release(lease)
        assert ring.put({"x": np.ones((3, 2), np.float32)}, version=1)

    def test_staleness_bound_drops_at_get(self):
        ring = _ring(depth=4, max_staleness=1)
        for v in range(3):
            ring.put({"x": np.full((3, 2), float(v), np.float32)}, version=v)
        ring.set_consumer_version(2)
        lease = ring.get(timeout=1.0)
        assert lease.version == 1  # version 0 (lag 2) dropped
        assert ring.stats()["drops_stale"] == 1

    def test_block_policy_waits_for_free_slot(self):
        ring = _ring(depth=1, policy="block")
        assert ring.put({"x": np.zeros((3, 2), np.float32)}, version=0)
        assert not ring.put({"x": np.ones((3, 2), np.float32)}, version=1, timeout=0.05)
        ring.release(ring.get(timeout=1.0))
        assert ring.put({"x": np.ones((3, 2), np.float32)}, version=1)
        ring.close()
        assert not ring.put({"x": np.ones((3, 2), np.float32)}, version=2)

    def test_stats_gauge_row_fields(self):
        ring = _ring(depth=2)
        ring.put({"x": np.zeros((3, 2), np.float32)}, version=0)
        s = ring.stats()
        assert s["consume_transfer_bytes"] == 0
        assert s["enqueue_bytes"] == 3 * 2 * 4
        assert s["bytes_per_block"] == s["raw_bytes_per_block"] == 24
        assert s["slots"] == s["capacity"] == 2
        # TrajQueue's row keys, all of them.
        assert set(traj_queue.TrajQueue(1).stats()) <= set(s)


class TestCodecsThroughRing:
    def test_fp32_roundtrip_is_bitwise(self):
        a = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)
        ring = _ring()
        ring.put({"x": a}, version=0)
        np.testing.assert_array_equal(_decoded(ring, ring.get(timeout=1.0))["x"], a)

    @pytest.mark.parametrize("codec,bound", [("f16", 2e-3), ("int8", None)])
    def test_quantized_roundtrip_error_bounds(self, codec, bound):
        a = np.random.default_rng(1).normal(0, 2, size=(8, 4)).astype(np.float32)
        ring = dp_ring.DeviceTrajRing(depth=2, block_spec={"obs": S((8, 4), "float32")},
                                      codec=codec)
        assert ring.codecs["obs"] == ("f16" if codec == "f16" else "i8")
        ring.put({"obs": a}, version=0)
        decoded = _decoded(ring, ring.get(timeout=1.0))["obs"]
        if bound is None:
            # i8: scale / 127 an element, scale the running |x − mean| max.
            bound = float(ring.quant_host()["obs"]["scale"]) / 127.0 + 1e-6
        assert np.max(np.abs(decoded - a)) <= bound

    def test_int8_flags_and_small_ints_exact(self):
        spec = {"done": S((4, 2), "float32"), "action": S((4, 2), "int64")}
        ring = dp_ring.DeviceTrajRing(depth=1, block_spec=spec, codec="int8")
        done = np.asarray([[0, 1]] * 4, np.float32)
        action = np.asarray([[0, 1]] * 4, np.int64)
        ring.put({"done": done, "action": action}, version=0)
        out = _decoded(ring, ring.get(timeout=1.0))
        np.testing.assert_array_equal(out["done"], done)
        np.testing.assert_array_equal(out["action"], action)

    @pytest.mark.parametrize("kind", ["i8", "f16", "bool8", "i8_unit", "raw"])
    def test_torch_decode_equals_numpy_mirror_exactly(self, kind):
        """The encode is numpy's on the host, the decode torch's on the card:
        with one stats tree the two decodes agree bit for bit."""
        rng = np.random.default_rng(2)
        x = rng.normal(0, 3, size=(64, 4)).astype(np.float32)
        if kind == "bool8":
            x = (x > 0).astype(np.float32)
        elif kind == "i8_unit":
            x = np.tanh(x)
        stats = np_codecs.np_update_stats(kind, np_codecs.np_init_stats(kind, ()), x)
        codes = np_codecs.np_encode(kind, stats, x)
        host = np_codecs.np_decode(kind, stats, codes)
        tstats = quantize.QuantStats(mean=torch.from_numpy(np.asarray(stats["mean"])),
                                     scale=torch.from_numpy(np.asarray(stats["scale"])),
                                     count=torch.tensor(int(stats["count"])))
        dev = dp_ring.decode_leaf(kind, tstats, torch.from_numpy(codes)).numpy()
        assert dev.dtype == host.dtype
        np.testing.assert_array_equal(dev, host)

    def test_ring_decode_equals_numpy_mirror_through_slots(self):
        """Blocks encoded under calibrating stats each decode with their own
        encode's stats (the slot's), equal to the numpy mirror."""
        spec = {"obs": S((4, 2, 3), "float32"), "reward": S((4, 2), "float32")}
        ring = dp_ring.DeviceTrajRing(depth=3, block_spec=spec, codec="int8")
        rng = np.random.default_rng(4)
        want = []
        for v in range(3):
            block = {"obs": rng.normal(0, 1 + v, (4, 2, 3)).astype(np.float32),
                     "reward": rng.normal(size=(4, 2)).astype(np.float32)}
            ring.put(block, version=v)
            st = ring.quant_host()
            want.append({k: np_codecs.np_decode("i8", st[k], np_codecs.np_encode("i8", st[k], x))
                         for k, x in block.items()})
        for v in range(3):
            got = _decoded(ring, ring.get(timeout=1.0))
            for k in spec:
                np.testing.assert_array_equal(got[k], want[v][k], err_msg=f"{v} {k}")

    def test_np_stats_calibrate_then_freeze(self):
        stats = np_codecs.np_init_stats("i8", ())
        big = np.full((quantize.CALIBRATION_TRANSITIONS,), 5.0, np.float32)
        stats = np_codecs.np_update_stats("i8", stats, big)
        stats2 = np_codecs.np_update_stats("i8", stats, np.full((64,), -100.0, np.float32))
        assert float(stats2["mean"]) == float(stats["mean"])
        assert float(stats2["scale"]) == float(stats["scale"])

    def test_calibration_clock_counts_transitions_not_elements(self):
        stats = np_codecs.np_update_stats("i8", np_codecs.np_init_stats("i8", ()),
                                          np.ones((64, 8), np.float32), num_transitions=64)
        assert int(stats["count"]) == 64
        spec = {"obs": S((4, 2, 3), "float32"), "reward": S((4, 2), "float32"),
                "last_obs": S((2, 3), "float32")}
        ring = dp_ring.DeviceTrajRing(depth=2, block_spec=spec, codec="int8")
        assert ring._transitions_per_put == {"obs": 8, "reward": 8, "last_obs": 2}
        rng = np.random.default_rng(0)
        ring.put({k: rng.normal(size=v.shape).astype(np.float32) for k, v in spec.items()},
                 version=0)
        q = ring.quant_host()
        assert (int(q["obs"]["count"]), int(q["reward"]["count"]),
                int(q["last_obs"]["count"])) == (8, 8, 2)

    def test_raw_keys_never_quantize(self):
        spec = {"log_prob": S((4, 2), "float32"), "value": S((4, 2), "float32"),
                "action": S((4, 2, 1), "float32")}
        assert np_codecs.traj_codecs("int8", spec) == {
            "log_prob": "raw", "value": "raw", "action": "raw"}

    def test_bad_codec_mode_rejected(self):
        with pytest.raises(ValueError, match="data-plane codec"):
            np_codecs.traj_codecs("bf16", {"x": S((1,), "float32")})


@pytest.mark.parametrize("kind", ["raw", "f16", "bool8", "i8_unit", "i8"])
def test_numpy_codecs_equal_jax_bitwise(kind):
    """The port's numpy codecs against JAX's `data_plane/codecs.py` on the
    same arrays: every stats update (calibrating, then frozen), encode and
    decode bit for bit, saturation and NaN included."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 4, size=(48, 3)).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2] = np.nan, 1e9, -1e9
    blocks = [x, (x * 0.5 + 1).astype(np.float32),
              rng.normal(size=(quantize.CALIBRATION_TRANSITIONS, 3)).astype(np.float32), x]
    mine, theirs = np_codecs.np_init_stats(kind, ()), jcodecs.np_init_stats(kind, ())
    for b in blocks:
        mine = np_codecs.np_update_stats(kind, mine, b, num_transitions=b.shape[0])
        theirs = jcodecs.np_update_stats(kind, theirs, b, num_transitions=b.shape[0])
        for k in ("mean", "scale", "count"):
            assert np.asarray(mine[k]).dtype == np.asarray(theirs[k]).dtype
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        q_m, q_j = np_codecs.np_encode(kind, mine, b), jcodecs.np_encode(kind, theirs, b)
        assert q_m.dtype == q_j.dtype == np_codecs.storage_np_dtype(kind, np.float32)
        np.testing.assert_array_equal(q_m, q_j)
        np.testing.assert_array_equal(np_codecs.np_decode(kind, mine, q_m),
                                      jcodecs.np_decode(kind, theirs, q_j))
    for mode in np_codecs.TRAJ_MODES:
        spec = {k: S((2,), "float32") for k in ("obs", "reward", "done", "value", "other")}
        spec["action"] = S((2,), "int64")
        assert np_codecs.traj_codecs(mode, spec) == jcodecs.traj_codecs(mode, spec)


def test_quant_host_install_roundtrip():
    spec = {"obs": S((8, 4), "float32")}
    ring = dp_ring.DeviceTrajRing(depth=2, block_spec=spec, codec="int8")
    ring.put({"obs": np.random.default_rng(3).normal(0, 2, (8, 4)).astype(np.float32)},
             version=0)
    saved = ring.quant_host()
    assert float(saved["obs"]["scale"]) > quantize._EPS
    # A fresh ring (a resume): storage zeroed, the stats restored; new blocks
    # encode against the run's standardization, and their slots carry it.
    ring2 = dp_ring.DeviceTrajRing(depth=2, block_spec=spec, codec="int8")
    ring2.install_quant(host_loop.ring_quant_tree(host_loop.ring_quant_tensors(saved)))
    again = ring2.quant_host()
    for k in ("mean", "scale", "count"):
        np.testing.assert_array_equal(again["obs"][k], saved["obs"][k])
    frozen = {"obs": dict(saved["obs"], count=np.asarray(quantize.CALIBRATION_TRANSITIONS,
                                                          np.int32))}
    ring2.install_quant(frozen)
    ring2.put({"obs": np.zeros((8, 4), np.float32)}, version=0)
    lease = ring2.get(timeout=1.0)
    assert float(ring2.state.quant["obs"].scale[lease.slot]) == float(saved["obs"]["scale"])


@pytest.mark.parametrize("replay_dtype", ["fp32", "mixed"])
def test_ddpg_device_ingest_equals_jax_replay(replay_dtype):
    """Two staged blocks through the device ingest (gather, decode, the
    replay ring, the gate) leave the replay ring JAX's host ingest leaves
    after the same blocks: bit for bit with the fp32 replay; with the mixed
    replay the running stats' batch mean may differ from XLA:CPU's in the
    last bit (test_torch_quantize.py), so the stats are held at 1e-6
    relative and the int8 codes within one step."""
    from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec
    from actor_critic_tpu_torch.envs import EnvSpec

    kw = dict(num_envs=2, steps_per_iter=4, updates_per_iter=1, buffer_capacity=64,
              batch_size=4, warmup_steps=1000, hidden=(8,), replay_dtype=replay_dtype)
    jcfg, cfg = jddpg.DDPGConfig(**kw), tddpg.DDPGConfig(**kw)
    spec = EnvSpec(obs_shape=(3,), action_dim=1, discrete=False)
    assert JaxEnvSpec(obs_shape=(3,), action_dim=1, discrete=False).obs_shape == spec.obs_shape
    K, E = cfg.steps_per_iter, cfg.num_envs
    block_spec = device_replay.offpolicy_block_spec(spec, cfg, 1)
    ring = dp_ring.DeviceTrajRing(depth=2, block_spec=block_spec, codec="fp32")
    jls = jddpg.init_learner((3,), 1, jcfg, jax.random.key(0))
    port = tddpg.init_learner((3,), 1, cfg, device="cpu")
    load_learner(port, jls)
    ingest = device_replay.make_device_ingest_update(tddpg.make_host_ingest_update(1, cfg),
                                                     ring.codecs)
    jingest = jax.jit(jddpg.make_host_ingest_update(1, jcfg))
    rng = np.random.default_rng(0)
    steps = torch.zeros((), dtype=torch.int64)
    for _ in range(2):
        block = {
            "obs": rng.normal(size=(K, E, 3)).astype(np.float32),
            "action": np.tanh(rng.normal(size=(K, E, 1))).astype(np.float32),
            "reward": rng.normal(size=(K, E)).astype(np.float32),
            "done": np.zeros((K, E), np.float32),
            "terminated": np.zeros((K, E), np.float32),
            "final_obs": rng.normal(size=(K, E, 3)).astype(np.float32),
            "last_obs": rng.normal(size=(E, 3)).astype(np.float32),
        }
        ring.put(block, version=0)
        lease = ring.get(timeout=1.0)
        ring.select(lease)
        ingest(port, ring.state, ring.slot_index, steps, torch.Generator())
        ring.release(lease)
        traj = JTransition(obs=jnp.asarray(block["obs"]), action=jnp.asarray(block["action"]),
                           reward=jnp.asarray(block["reward"]),
                           next_obs=jnp.asarray(block["final_obs"]),
                           terminated=jnp.asarray(block["terminated"]),
                           done=jnp.asarray(block["done"]))
        jls, _ = jingest(jls, traj, jnp.asarray(0, jnp.int32))
    assert int(port.replay.size) == int(jls.replay.size) == 2 * K * E
    assert int(port.update_count) == 0  # the gate stayed shut
    for name in ("obs", "action", "reward", "next_obs", "terminated", "done"):
        got = getattr(port.replay.storage, name).numpy()
        want = np.asarray(getattr(jls.replay.storage, name))
        assert got.dtype == want.dtype, name
        if replay_dtype == "fp32" or got.dtype != np.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
    jq = jls.replay.quant
    for name in ("obs", "reward"):
        for field in ("mean", "scale"):
            np.testing.assert_allclose(getattr(getattr(port.replay.quant, name), field).numpy(),
                                       np.asarray(getattr(getattr(jq, name), field)),
                                       rtol=1e-6, atol=0, err_msg=f"{name} {field}")


@pytest.fixture
def cpu_learner():
    """One intra-op thread (the learner's ops beside the actor threads would
    otherwise oversubscribe the cores) and a 0.1 ms GIL switch interval: an
    actor's Python loop holds the GIL up to the interval (5 ms by default)
    each time a learner op releases it, and at 5 ms the CPU learner's
    thousands of ops a block take minutes. On the card an update is one
    graph replay, a single call."""
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(interval)
    torch.set_num_threads(threads)


class _Poisoner:
    """Wraps `host_loop.make_async_queue`: every release first overwrites
    the slot's storage with NaN (floats) and junk (ints), as the put that
    reuses the slot may at once, then returns the slot to the pool (a
    poison after that could land on the next put's block)."""

    def __init__(self, make):
        self.make, self.poisoned = make, 0

    def __call__(self, *args, **kwargs):
        queue = self.make(*args, **kwargs)
        release = queue.release

        def poisoning_release(block):
            if isinstance(queue, dp_ring.DeviceTrajRing):
                for t in queue.state.storage.values():
                    t[block.slot].fill_(float("nan") if t.is_floating_point() else 77)
            else:
                for a in block.arrays.values():
                    a[...] = np.nan if np.issubdtype(a.dtype, np.floating) else 77
            self.poisoned += 1
            release(block)

        queue.release = poisoning_release
        return queue


@pytest.mark.parametrize("plane", ["host", "device"])
def test_slot_poisoner_leaves_the_update_unchanged(plane, monkeypatch, cpu_learner):
    """After `release` the slot is overwritten with NaN; the async learner's
    result (strict lockstep, so the run is deterministic) must not move:
    the host plane's update reads the learner's own copy, the device
    plane's slot is released only after its last update."""
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=8, epochs=2, num_minibatches=2, hidden=(8,))

    def run():
        pool = HostEnvPool("Pendulum-v1", 2, seed=0, backend="native")
        try:
            net, opt_state, _ = ppo.train_host_async(
                [pool], cfg, 3, seed=0, log_every=0, queue_depth=1, correction="none",
                strict_lockstep=True, data_plane=plane, device="cpu")
        finally:
            pool.close()
        return [p.detach().clone() for p in net.parameters()], opt_state

    clean, clean_opt = run()
    poisoner = _Poisoner(host_loop.make_async_queue)
    monkeypatch.setattr(host_loop, "make_async_queue", poisoner)
    dirty, dirty_opt = run()
    assert poisoner.poisoned == 3
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)
    for k in clean_opt.mu:
        assert torch.equal(clean_opt.mu[k], dirty_opt.mu[k])


class TestSequenceConsumer:
    def _seq(self, done_rows, lib="torch"):
        done = np.asarray(done_rows, np.float32)
        B, L = done.shape
        base = np.arange(B * L, dtype=np.float32).reshape(B, L)
        if lib == "jax":
            d, b = jnp.asarray(done), jnp.asarray(base)
            return JTransition(obs=b[..., None], action=b[..., None], reward=b,
                               next_obs=b[..., None], terminated=d, done=d)
        d, b = torch.from_numpy(done), torch.from_numpy(base)
        return OffPolicyTransition(obs=b[..., None], action=b[..., None], reward=b,
                                   next_obs=b[..., None], terminated=d, done=d)

    def test_window_mask_alive_before_done_as_jax(self):
        rows = [[0, 1, 0, 0], [0, 0, 0, 0], [1, 0, 1, 0]]
        mask = device_replay.sequence_window_mask(torch.tensor(rows, dtype=torch.float32))
        np.testing.assert_array_equal(mask.numpy()[:2], [[1, 1, 0, 0], [1, 1, 1, 1]])
        want = jdevice_replay.sequence_window_mask(jnp.asarray(rows, jnp.float32))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))

    def test_mask_matches_nstep_batch_convention(self):
        seq = self._seq([[0, 1, 0], [0, 0, 0], [1, 0, 0]])
        batch, _ = tddpg.nstep_batch(seq, gamma=1.0)
        mask = device_replay.sequence_window_mask(seq.done)
        np.testing.assert_allclose(batch.reward.numpy(), (seq.reward * mask).sum(dim=1).numpy())

    @pytest.mark.parametrize("burn_in", [0, 2])
    def test_split_burn_in_as_jax(self, burn_in):
        rows = [[0, 1, 0, 0, 0], [0, 0, 0, 1, 0]]  # a done inside the burn-in, one after
        burn, train, mask = device_replay.split_burn_in(self._seq(rows), burn_in)
        jburn, jtrain, jmask = jdevice_replay.split_burn_in(self._seq(rows, "jax"), burn_in)
        assert (burn is None) == (jburn is None) == (burn_in == 0)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(train.reward.numpy(), np.asarray(jtrain.reward))
        if burn_in:
            assert burn.reward.shape == (2, 2) and train.reward.shape == (2, 3)
            np.testing.assert_array_equal(burn.reward.numpy(), np.asarray(jburn.reward))
            # The burn-in's done invalidates EVERY train step after it.
            np.testing.assert_array_equal(mask.numpy()[0], [0, 0, 0])

    def test_sample_training_sequences_draws_consecutive_inserts(self):
        z = torch.zeros(())
        example = OffPolicyTransition(obs=z, action=z, reward=z, next_obs=z, terminated=z,
                                      done=z)
        state = replay.init(example, capacity=32)
        v24 = torch.arange(24, dtype=torch.float32)
        replay.add_batch(state, OffPolicyTransition(obs=v24, action=v24, reward=v24,
                                                    next_obs=v24, terminated=torch.zeros(24),
                                                    done=torch.zeros(24)))
        burn, train, mask = device_replay.sample_training_sequences(
            state, torch.Generator().manual_seed(0), 16, 4, burn_in=2)
        v = torch.cat([burn.reward, train.reward], dim=1).numpy()
        assert v.shape == (16, 6) and mask.shape == (16, 4)
        np.testing.assert_array_equal(np.diff(v, axis=1), 1.0)
        # JAX's ring under the same contract.
        jstate = jreplay.add_batch(
            jreplay.init({"v": jnp.zeros(()), "done": jnp.zeros(())}, capacity=32),
            {"v": jnp.arange(24, dtype=jnp.float32), "done": jnp.zeros(24)})
        out = jreplay.sample_sequences(jstate, jax.random.key(0), 16, 6)
        np.testing.assert_array_equal(np.diff(np.asarray(out["v"]), axis=1), 1.0)
