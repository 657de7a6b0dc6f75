"""The port's data parallelism of the fused trainers (`parallel/mesh.py`'s
mesh, `parallel/dp.py`, each trainer's `group`) on the CPU, over two gloo
ranks spawned as processes (`tests/torch_parallel_worker.py`, once for the
module), against the JAX package's (`tests/test_parallel.py`):

- the mesh over the world: its shape, coordinates and line groups, and
  JAX's "mesh {dp}x{model} != {n} devices" refusal;
- the sharded gradient (each rank's env shard, pmean'd through
  `FlatGradients`) equals the full-batch gradient, the port's and JAX's
  (rtol 1e-5, atol 1e-6), with plain and with globally normalized
  advantages;
- one dp step of A2C, PPO, IMPALA, TD3 with a float32 and with an int8 ring,
  and SAC (two iterations): every replicated tensor (parameters, moments,
  counts, targets, log α, the quantizer's stats, the ring's cursor) and
  every metric bitwise equal across ranks, the env shards and sub-rings
  each rank's own (capacity / W rows), the counts as JAX's test has them;
- the same steps through a one-rank group equal the steps with no group
  at 0.0;
- the quantizer's stats with the group equal JAX's `update_stats` with
  `axis_name` on a 2-device mesh;
- dp A2C learns the two-state MDP (π(a=1) > 0.9, JAX's threshold);
- `make_dp_train_step` refuses ranks whose replicated state differs, and
  `distribute_state` an indivisible env batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from actor_critic_tpu.algos import a2c as ja2c
from actor_critic_tpu.algos.common import Transition as JTransition
from actor_critic_tpu.envs import make_two_state_mdp as make_jax_mdp
from actor_critic_tpu.parallel.mesh import shard_map
from actor_critic_tpu.replay import quantize as jquantize
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import a2c
from actor_critic_tpu_torch.algos.common import Transition
from actor_critic_tpu_torch.envs import make_two_state_mdp
from actor_critic_tpu_torch.parallel import dp, mesh
from torch_parallel_worker import run_ranks
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

WORLD = 2
TRAINERS = ["a2c", "ppo", "impala", "td3_fp32", "td3_int8", "sac"]
GRAD_T, GRAD_E = 4, 16
LEARN_ITERATIONS = 200
SHARDED = ("rollout", "env ", "ep_return", "ep_length", "learner.replay storage")


def _grad_inputs():
    jcfg = ja2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,))
    net = ja2c.make_network(make_jax_mdp(), jcfg)
    params = net.init(jax.random.key(0), jnp.zeros((1, 2)))
    rng = np.random.RandomState(0)
    traj = dict(
        obs=rng.rand(GRAD_T, GRAD_E, 2).astype(np.float32),
        action=rng.randint(0, 2, (GRAD_T, GRAD_E)),
        log_prob=np.zeros((GRAD_T, GRAD_E), np.float32),
        value=np.zeros((GRAD_T, GRAD_E), np.float32),
        reward=rng.rand(GRAD_T, GRAD_E).astype(np.float32),
        done=np.zeros((GRAD_T, GRAD_E), np.float32),
        terminated=np.zeros((GRAD_T, GRAD_E), np.float32),
        final_obs=rng.rand(GRAD_T, GRAD_E, 2).astype(np.float32),
    )
    adv = rng.randn(GRAD_T, GRAD_E).astype(np.float32)
    ret = rng.randn(GRAD_T, GRAD_E).astype(np.float32)
    return net, params, traj, adv, ret


def _stats_batch():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(64, 3)) * np.array([1.0, 5.0, 0.1]) + 2.0).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, params, traj, adv, ret = _grad_inputs()
    grad_in = {f"param.{k}": v.numpy() for k, v in
               weights.from_flax(jax.device_get(params)).items()}
    grad_in.update({f"traj.{k}": v for k, v in traj.items()}, adv=adv, ret=ret)
    cases = [("mesh", "mesh", {}, {}),
             ("grad_plain", "grad", {"normalize_adv": False}, grad_in),
             ("grad_norm", "grad", {"normalize_adv": True}, grad_in),
             ("stats", "stats", {"chunk": 8}, {"batch": _stats_batch()})]
    cases += [(f"dp_{t}", "dp_step", {"trainer": t, "iterations": 2}, {}) for t in TRAINERS]
    cases += [("world1", "world1", {"trainers": TRAINERS}, {}),
              ("learn", "learn", {"iterations": LEARN_ITERATIONS}, {}),
              ("mismatch", "mismatch", {}, {})]
    return run_ranks(WORLD, cases, tmp_path_factory.mktemp("parallel"))


def test_mesh_over_the_world(ranks):
    res = ranks["mesh"]
    for r, out in enumerate(res):
        assert int(out["dp"]) == WORLD and int(out["index"]) == r
        # jax.make_mesh's row-major device order: rank r sits at (r // 1, r % 1).
        assert out["grid_index"].tolist() == [r, 0]
        assert out["grid_sizes"].tolist() == [2, 1, 2]
        assert out["sp_line"].tolist() == [0.0, 1.0]
        assert str(out["error"]) == f"mesh {WORLD + 1}x1 != {WORLD} devices"


def test_mesh_without_a_process_group():
    m = mesh.make_mesh()
    assert m.shape == {"dp": 1, "model": 1} and m.group("dp") is None
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        mesh.make_mesh(mesh.MeshConfig(dp=2))
    x = torch.arange(3.0)
    assert mesh.pmax(x, None) is x and mesh.all_gather(x, None).shape == (1, 3)


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "normalized"])
def test_sharded_grad_equals_full_batch_grad(ranks, norm):
    """The pmean of per-shard gradients is the full batch's gradient (JAX's
    core data-parallel property), with the advantage statistics global
    when they are normalized."""
    net, params, traj, adv, ret = _grad_inputs()
    full = {}
    if not norm:
        jcfg = ja2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,))
        jtraj = JTransition(**{k: jnp.asarray(v) for k, v in traj.items()})
        jg = jax.grad(lambda p: ja2c.a2c_loss(p, net.apply, jtraj, jnp.asarray(adv),
                                              jnp.asarray(ret), jcfg)[0])(params)
        full["jax"] = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(jg)).items()}
    cfg = a2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,), normalize_adv=norm)
    tnet = a2c.make_network(make_two_state_mdp(), cfg)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    loss, _ = a2c.a2c_loss(tnet, Transition(**{k: torch.from_numpy(v) for k, v in traj.items()}),
                           torch.from_numpy(adv), torch.from_numpy(ret), cfg)
    tparams = dict(tnet.named_parameters())
    full["port"] = {k: g.numpy() for k, g in
                    zip(tparams, torch.autograd.grad(loss, list(tparams.values())))}
    res = ranks[f"grad_{'norm' if norm else 'plain'}"]
    for side, want in full.items():
        for k, v in want.items():
            for r in range(WORLD):
                np.testing.assert_allclose(res[r][f"grad.{k}"], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{side} rank {r} {k}")
    for k in full["port"]:
        np.testing.assert_array_equal(res[0][f"grad.{k}"], res[1][f"grad.{k}"])


def _replicated(key: str) -> bool:
    return not key.startswith(tuple(f"state.{p}" for p in SHARDED))


@pytest.mark.parametrize("trainer", TRAINERS)
def test_dp_step_replicates_and_shards(ranks, trainer):
    res = ranks[f"dp_{trainer}"]
    a, b = res
    assert sorted(a) == sorted(b)
    for k in a:
        if k.startswith("metric.") or _replicated(k):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["state.step_counter"].tolist() == [2]
    loss = a["metric.critic_loss"] if "metric.critic_loss" in a else a["metric.loss"]
    assert np.isfinite(loss)
    if trainer.startswith(("td3", "sac")):
        ring = "state.learner.replay storage.obs"
        assert a[ring].shape[0] == 512 // WORLD
        # Each rank's sub-ring holds its own envs' transitions.
        assert not np.array_equal(a[ring], b[ring])
        # 2 iterations × 4 steps × 8 local envs; 2 updates an iteration.
        assert int(a["state.learner.replay size"]) == 2 * 4 * (16 // WORLD)
        assert int(a["state.learner.update_count"]) == 4
    if trainer == "td3_int8":
        assert int(a["state.learner.replay quant.obs.count"]) > 0
        assert a["state.learner.replay storage.obs"].dtype == np.int8
        assert (a["state.learner.replay quant.obs.scale"] > 1e-3).all()
    if trainer == "impala":
        # Step 2 is a refresh boundary: the actors hold the learner's params.
        for k in a:
            if k.startswith("state.param "):
                np.testing.assert_array_equal(a[k], a[k.replace("param ", "actor_net ")])
    if trainer == "sac":
        assert np.isfinite(a["metric.alpha"])
        np.testing.assert_array_equal(a["state.learner.log_alpha"], b["state.learner.log_alpha"])


def test_dp_env_batches_are_each_ranks_own(ranks):
    """The env shards of the on-policy trainers hold E / W envs each."""
    for trainer, E in (("a2c", 32), ("ppo", 16), ("impala", 16)):
        for out in ranks[f"dp_{trainer}"]:
            assert out["state.ep_return"].shape == (E // WORLD,)
            assert out["state.rollout obs"].shape[0] == E // WORLD


@pytest.mark.parametrize("trainer", TRAINERS)
def test_world1_group_equals_no_group(ranks, trainer):
    for out in ranks["world1"]:
        assert int(out[f"{trainer}.tensors"]) > 10
        assert float(out[f"{trainer}.max_diff"]) == 0.0
        assert int(out[f"{trainer}.mismatches"]) == 0


def test_quantizer_stats_match_jax_and_agree(ranks):
    batch = _stats_batch()
    m = jax.make_mesh((WORLD,), ("dp",), devices=jax.devices()[:WORLD])

    def fold(x):
        stats = jquantize.init_stats("i8", x[0])
        for lo in range(0, x.shape[0], 8):
            stats = jquantize.update_stats("i8", stats, x[lo:lo + 8], axis_name="dp")
        return stats

    want = shard_map(fold, mesh=m, in_specs=(JP("dp"),), out_specs=JP(), check_vma=False)(
        jnp.asarray(batch))
    a, b = ranks["stats"]
    for k in ("mean", "scale", "count"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["mean"], np.asarray(want.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a["scale"], np.asarray(want.scale), rtol=1e-6, atol=1e-6)
    assert int(a["count"]) == int(want.count) == batch.shape[0] // WORLD


def test_dp_learning_two_state(ranks):
    for out in ranks["learn"]:
        assert float(out["p1"].min()) > 0.9, f"dp training failed to learn: P(a=1)={out['p1']}"
    np.testing.assert_array_equal(ranks["learn"][0]["p1"], ranks["learn"][1]["p1"])


def test_dp_step_refuses_ranks_that_differ(ranks):
    for out in ranks["mismatch"]:
        assert "replicated state differs" in str(out["error"])


def test_distribute_state_rejects_indivisible():
    env = make_two_state_mdp()
    cfg = a2c.A2CConfig(num_envs=12, rollout_steps=4, hidden=(16,))
    state = a2c.init_state(env, cfg, seed=0, device="cpu")
    eight = mesh.Mesh({"dp": 8, "model": 1}, 0, {("dp",): None, ("model",): None,
                                                 ("dp", "model"): None})
    with pytest.raises(ValueError, match="not divisible by dp=8"):
        dp.distribute_state(state, eight)


def test_distribute_state_layouts_name_every_field():
    env = make_two_state_mdp()
    cfg = a2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,))
    state = a2c.init_state(env, cfg, seed=0, device="cpu")
    one = mesh.make_mesh()
    with pytest.raises(ValueError, match="does not match"):
        dp.distribute_state(state, one, dp.impala_state_specs())
    seed = state.generator.initial_seed()
    shard = dp.distribute_state(state, one)
    assert shard.ep_return.shape == (8,)
    assert shard.generator.initial_seed() == dp.rank_seed(seed, 0) != seed
    with pytest.raises(ValueError, match="group=mesh.group"):
        dp.make_dp_train_step(lambda s: s, one)
