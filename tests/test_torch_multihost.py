"""The multi-process sync learner's update and collectives
(`parallel/mesh.py`, `parallel/multihost.py`, `ppo.make_async_update_fn`
with a group) on the CPU over gloo, against the JAX package's:

- one sync-mode update by two gloo ranks, each given its half of a
  [T, 2·E_a] block, against JAX's `make_multihost_update_step` shard_mapped
  over a 2-device CPU mesh, from the same parameters (`weights.from_flax`),
  the whole block and JAX's permutations: every parameter, both Adam
  moments and every metric within the single-host async update's bound
  (`tests/test_torch_async_host.py`: atol 1e-6, rtol 1e-5), the bitwise
  mismatches counted and printed (`-s`), and the two ranks bitwise equal
  to each other;
- the same update through a one-rank group equal to the update without a
  group at 0.0 (world 1: the all-reduce and the divide are exact);
- `normalize_advantages` with the group against JAX's with `axis_name` on
  the shard_mapped mesh (atol 1e-6);
- `make_consistency_check` at world 3, where a float sum of three equal
  fingerprints rounds: max == min holds exactly, a one-ulp divergence is
  caught, the version sum and the stop vote are exact;
- `aggregate_metrics` with a group of three against JAX's with
  `axis_name` on a 3-device mesh (atol 1e-6), and `pmean_tree` with the
  group against the ranks' mean;
- the pure pieces: `pmean`/`psum`/`pmean_tree`/`FlatGradients` as the
  identity without a group, and the refusal of two NCCL ranks on one card.

Each multi-process case spawns its ranks as processes
(`tests/torch_multihost_worker.py`), a few seconds each.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.ops.returns import normalize_advantages as jnormalize
from actor_critic_tpu.parallel import multihost as jmultihost
from actor_critic_tpu.parallel.mesh import shard_map
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.parallel import mesh, multihost

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, cases: dict[str, tuple[str, dict]], tmp_path) -> dict:
    """Run each case's (mode, inputs) on `world` gloo ranks (one process a
    rank, the cases one after the other in one group); returns each case's
    per-rank results."""
    for name, (_, inputs) in cases.items():
        np.savez(tmp_path / f"{name}_in.npz", **inputs)
    modes = ",".join(mode for mode, _ in cases.values())
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p))
    ins = ",".join(str(tmp_path / f"{name}_in.npz") for name in cases)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, modes, str(r), str(world), coordinator, ins,
         ",".join(str(tmp_path / f"{name}_out{r}.npz") for name in cases)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    results = {}
    for name in cases:
        results[name] = []
        for r in range(world):
            with np.load(tmp_path / f"{name}_out{r}.npz") as z:
                results[name].append({k: z[k] for k in z.files})
    return results


def _block(rng, T, E, obs_dim, discrete, A):
    obs = rng.normal(size=(T, E, obs_dim)).astype(np.float32)
    if discrete:
        action = rng.integers(0, A, (T, E))
        log_prob = (np.log(1 / A) + 0.3 * rng.normal(size=(T, E))).astype(np.float32)
    else:
        action = rng.normal(size=(T, E, A)).astype(np.float32)
        log_prob = (-2.0 + 0.5 * rng.normal(size=(T, E))).astype(np.float32)
    done = (rng.random((T, E)) < 0.15).astype(np.float32)
    return dict(obs=obs, action=action, log_prob=log_prob,
                value=rng.normal(size=(T, E)).astype(np.float32),
                reward=rng.normal(size=(T, E)).astype(np.float32), done=done,
                terminated=(done * (rng.random((T, E)) < 0.5)).astype(np.float32),
                final_obs=(obs + 0.1).astype(np.float32),
                last_obs=rng.normal(size=(E, obs_dim)).astype(np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _mismatches(got: np.ndarray, want: np.ndarray) -> int:
    return int((np.asarray(got) != np.asarray(want)).sum())


SYNC_CASES = {"discrete": True, "gaussian": False}


def _sync_case(discrete: bool):
    """One case's JAX result (the sync learner's program over a 2-device
    mesh) and the port's inputs."""
    from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec

    T, E_a, obs_dim, A = 8, 4, 4, (3 if discrete else 2)
    kw = dict(num_envs=2 * E_a, rollout_steps=T, epochs=2, num_minibatches=2, hidden=(16, 16),
              lr=1e-3, entropy_coef=0.01)
    jspec = JaxEnvSpec(obs_shape=(obs_dim,), action_dim=A, discrete=discrete)
    jcfg = jppo.PPOConfig(**kw)
    params, jopt = jppo.init_host_params(jspec, jcfg, jax.random.key(3))
    block = _block(np.random.default_rng(11), T, 2 * E_a, obs_dim, discrete, A)
    adv = np.random.default_rng(5).normal(1.5, 2.0, size=(2 * 96,)).astype(np.float32)

    m = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    update = jmultihost.make_multihost_update_step(jspec, jcfg, m)
    ukey = jax.random.key(17)
    key_data = np.asarray(jax.random.key_data(ukey))
    arrays = {k: (v.astype(np.int32) if k == "action" and discrete else v)
              for k, v in block.items()}
    jparams, jopt2, jmetrics = update(
        jmultihost.replicate_global(m, jax.device_get(params)),
        jmultihost.replicate_global(m, jax.device_get(jopt)), key_data,
        jmultihost.stage_global(m, arrays), np.float32(0.0))
    jax_out = dict(
        params=jmultihost.fetch_local(jparams), opt=jmultihost.fetch_local(jopt2),
        metrics={k: float(np.asarray(v.addressable_data(0))) for k, v in jmetrics.items()},
        norm=np.asarray(jax.jit(shard_map(lambda a: jnormalize(a, "dp"), mesh=m,
                                          in_specs=P("dp"), out_specs=P("dp"),
                                          check_vma=False))(adv)),
        updates=jcfg.epochs * jcfg.num_minibatches)
    # Every shard draws its local permutations from the replicated key.
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E_a))
                      for k in jax.random.split(ukey, jcfg.epochs)])
    state = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(params)).items()}
    meta = {"obs_shape": [obs_dim], "action_dim": A, "discrete": discrete,
            "cfg": {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}}
    inputs = {"meta": np.asarray(json.dumps(meta)), "perms": perms.astype(np.int64), "adv": adv,
              **{f"param.{k}": v for k, v in state.items()},
              **{f"block.{k}": v for k, v in block.items()}}
    return jax_out, inputs


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    """Both cases: JAX's results, and the two gloo ranks' (one spawn)."""
    cases = {name: _sync_case(discrete) for name, discrete in SYNC_CASES.items()}
    ranks = _run_ranks(2, {name: ("update", c[1]) for name, c in cases.items()},
                       tmp_path_factory.mktemp("sync"))
    return {name: (cases[name][0], ranks[name]) for name in cases}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_update_two_gloo_ranks_equals_jax_mesh(case, sync_runs):
    jax_out, ranks = sync_runs[case]
    jparams, jopt2, jmetrics, jnorm = (jax_out["params"], jax_out["opt"], jax_out["metrics"],
                                       jax_out["norm"])
    want = {k.replace(".kernel", ".weight"): (v.T if v.ndim == 2 else v)
            for k, v in _flat(jparams["params"]).items()}
    conv = weights.adam_state_from_optax(jopt2)
    mismatches, leaves = 0, 0
    for r, got in enumerate(ranks):
        for k, v in want.items():
            np.testing.assert_allclose(got[f"param.{k}"], v, **TOL, err_msg=f"rank {r} {k}")
            if r == 0:
                mismatches += _mismatches(got[f"param.{k}"], v)
                leaves += v.size
        for k in conv.mu:
            np.testing.assert_allclose(got[f"mu.{k}"], conv.mu[k].numpy(), **TOL, err_msg=k)
            np.testing.assert_allclose(got[f"nu.{k}"], conv.nu[k].numpy(), **TOL, err_msg=k)
        count = int(np.asarray(got["count"]).reshape(-1)[0])
        assert count == int(np.asarray(conv.count).reshape(-1)[0]) == jax_out["updates"]
        assert sorted(k[len("metric."):] for k in got if k.startswith("metric.")) == sorted(
            jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(got[f"metric.{k}"]), v, **TOL, err_msg=k)
        np.testing.assert_allclose(got["norm"], jnorm[r * 96:(r + 1) * 96],
                                   rtol=0, atol=1e-6)
        # World 1: a one-rank group is the single-host update, bit for bit.
        assert float(got["w1_max_diff"]) == 0.0 and int(got["w1_mismatches"]) == 0, got
        assert int(got["w1_tensors"]) > 2 * len(want)
    for k in ranks[0]:
        if k != "norm":  # each rank's own shard of the advantages
            assert np.array_equal(ranks[0][k], ranks[1][k]), f"ranks differ at {k}"
    print(f"sync update vs JAX's 2-device mesh ({case}): "
          f"{mismatches} of {leaves} parameter values differ bitwise from JAX's; the two ranks equal")


FINGERPRINT = 0.1  # three of them sum to 0.30000000000000004: a mean of sums rounds


def _metrics_case(world: int):
    """Each rank's row of the loss metrics, the episode accounting (rank 1
    finished no episode) and a small tree; and JAX's `aggregate_metrics`
    with `axis_name` over a `world`-device mesh on the same rows."""
    from actor_critic_tpu.algos.metrics import aggregate_metrics as jaggregate

    rng = np.random.default_rng(23)
    f32 = lambda *shape: rng.normal(size=(world, *shape)).astype(np.float32)
    metrics = {"loss": f32(), "entropy": f32()}
    episodes = np.asarray([3.0, 0.0, 5.0][:world], np.float32)
    ep = {"episodes_finished": episodes, "finished_return_sum": f32() * episodes,
          "finished_length_sum": 40.0 * episodes, "avg_return_ema": f32()}
    tree = {"a": f32(2, 3), "b": f32()}
    m = Mesh(np.asarray(jax.devices()[:world]), ("dp",))
    agg = jax.jit(shard_map(lambda mt, e: jaggregate(mt, e, "dp"), mesh=m,
                            in_specs=(P("dp"), P("dp")), out_specs=P("dp"),
                            check_vma=False))(metrics, ep)
    inputs = {**{f"metric.{k}": v for k, v in metrics.items()},
              **{f"ep.{k}": v for k, v in ep.items()},
              **{f"tree.{k}": v for k, v in tree.items()}}
    return {k: np.asarray(v) for k, v in agg.items()}, tree, inputs


@pytest.fixture(scope="module")
def world3_runs(tmp_path_factory):
    """The consistency check's and the metrics' cases on three gloo ranks
    (one spawn), with JAX's aggregate and the tree's inputs."""
    jagg, tree, inputs = _metrics_case(3)
    ranks = _run_ranks(3, {"check": ("check", {"fingerprint": np.asarray(FINGERPRINT)}),
                           "metrics": ("metrics", inputs)}, tmp_path_factory.mktemp("world3"))
    return ranks, jagg, tree


def test_consistency_check_is_exact_at_world_3(world3_runs):
    fp = FINGERPRINT
    for got in world3_runs[0]["check"]:
        vsum, fp_max, fp_min, votes = got["equal"]
        assert vsum == 3 * 7.0 and votes == 1.0
        assert fp_max == fp_min == fp
        assert float(got["sum_mean"]) != fp  # why the check compares max with min
        vsum, fp_max, fp_min, votes = got["off"]
        assert vsum == 21.0 and votes == 0.0
        assert fp_min == fp and fp_max == np.nextafter(fp, np.inf)


def test_aggregate_metrics_with_a_group_equals_jax_axis_name(world3_runs):
    """`aggregate_metrics` with a group of three gloo ranks against JAX's
    with `axis_name` on a 3-device mesh (atol 1e-6): the loss metrics
    pmean'd, the episode sums psum'd then divided (rank 1 finished none),
    `avg_return_ema` each rank's own; `pmean_tree` of the ranks' slices
    against their float64 mean (atol 1e-6)."""
    ranks, jagg, tree = world3_runs
    for r, got in enumerate(ranks["metrics"]):
        assert sorted(k[len("agg."):] for k in got if k.startswith("agg.")) == sorted(jagg)
        for k, v in jagg.items():
            np.testing.assert_allclose(got[f"agg.{k}"], v[r], rtol=0, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        for k, v in tree.items():
            np.testing.assert_allclose(got[f"tree.{k}"], v.astype(np.float64).mean(0),
                                       rtol=0, atol=1e-6, err_msg=f"rank {r} tree {k}")
            assert got[f"tree.{k}"].shape == v.shape[1:]


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert mesh.pmean(x, None) is x and mesh.psum(x, None) is x
    tree = {"a": x, "b": torch.tensor(2.0)}
    assert mesh.pmean_tree(tree, None) is tree
    grads = [torch.ones(3), torch.zeros(2, 2)]
    assert all(a is b for a, b in zip(mesh.FlatGradients(None)(grads), grads))
    assert mesh.world_size(None) == 1


def test_two_nccl_ranks_on_one_card_are_refused():
    """NCCL refuses two ranks on one GPU; the fleet says so and never moves
    to gloo unasked."""
    multihost.nccl_ranks_fit(2, 2)
    multihost.nccl_ranks_fit(1, 1)
    with pytest.raises(RuntimeError, match="two ranks on one GPU"):
        multihost.nccl_ranks_fit(2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            multihost.distributed_init("127.0.0.1:1", 2, 0, "cuda")
