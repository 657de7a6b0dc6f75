"""The port's sequence parallelism (`parallel/seqpar.py`, IMPALA's
`make_sp_update` / `make_sp_train_step`) on the CPU, over W gloo ranks
spawned as processes (`tests/torch_parallel_worker.py`), against the JAX
package's `seqpar_*` on its fake CPU mesh (`make_sp_mesh(n_devices=W)`)
and the plain scans of `ops/returns.py`, at JAX's tolerances
(`tests/test_seqpar.py`):

- discounted returns, GAE, V-trace (vs, pg advantages, clipped ρ), the
  no-dones boundary case and a T=4096 trajectory over W segments, at
  W = 2 and 4 (1e-5; 1e-4 for the long case); each rank returns its
  segment and the test joins them;
- the sp learner update at W = 4, as sp4 and as sp2 × dp2: equal to the
  unsharded `impala_loss` + RMSProp step (params 1e-4 / 1e-5, loss and mean
  ρ 1e-5) and to JAX's `make_sp_update` on the same parameters
  (`weights.from_flax`);
- the sp train step at W = 4 for three iterations: sp4 against the
  single-device step, sp2 × dp2 against the dp step over the same dp
  groups (JAX's 2e-4 / 1e-5 on params, 1e-4 on metrics), the same metric
  keys;
- without a group each `seqpar_*` is the plain scan (the kernel's plain
  version on the CPU), GAE's at 0.0.

The ranks of one world size are spawned once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.algos import impala as jimpala
from actor_critic_tpu.envs import make_two_state_mdp as make_jax_mdp
from actor_critic_tpu.ops import returns as jreturns
from actor_critic_tpu.parallel import seqpar as jseqpar
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.algos import impala as timpala
from actor_critic_tpu_torch.envs import make_two_state_mdp
from actor_critic_tpu_torch.ops import returns
from actor_critic_tpu_torch.parallel import seqpar
from torch_parallel_worker import run_ranks
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

T, E = 64, 5
GAMMA, LAM = 0.99, 0.95
TOL = dict(rtol=1e-5, atol=1e-5)
LONG_TOL = dict(rtol=1e-4, atol=1e-4)
SP_T, SP_E = 512, 8
SP_CFG = dict(num_envs=SP_E, rollout_steps=SP_T, hidden=[16])
TRAIN_CFG = dict(num_envs=8, rollout_steps=64, hidden=[16], actor_refresh_every=2)
LAYOUTS = ["1d", "2d"]


def _scan_inputs() -> dict:
    rng = np.random.default_rng(0)
    out = dict(
        rewards=rng.normal(size=(T, E)).astype(np.float32),
        values=rng.normal(size=(T, E)).astype(np.float32),
        dones=(rng.random((T, E)) < 0.15).astype(np.float32),
        bootstrap=rng.normal(size=(E,)).astype(np.float32),
    )
    rng = np.random.default_rng(1)
    out.update(target_lp=(rng.normal(size=(T, E)) * 0.3).astype(np.float32),
               behav_lp=(rng.normal(size=(T, E)) * 0.3).astype(np.float32))
    out.update(nodones_rewards=np.ones((T, 1), np.float32), nodones_values=np.zeros((T, 1),
                                                                                   np.float32),
               nodones_dones=np.zeros((T, 1), np.float32), nodones_bootstrap=np.zeros(1,
                                                                                     np.float32))
    rng = np.random.default_rng(2)
    Tl = 4096
    out.update(long_rewards=rng.normal(size=(Tl,)).astype(np.float32),
               long_values=rng.normal(size=(Tl,)).astype(np.float32),
               long_dones=(rng.random(Tl) < 0.01).astype(np.float32),
               long_bootstrap=np.asarray(0.3, np.float32))
    return out


def _sp_traj() -> tuple[dict, np.ndarray]:
    """JAX's `test_sp_impala_update_matches_unsharded` trajectory."""
    rng = np.random.default_rng(3)
    traj = dict(
        obs=rng.random((SP_T, SP_E, 2)).astype(np.float32),
        action=rng.integers(0, 2, (SP_T, SP_E)),
        log_prob=(rng.normal(size=(SP_T, SP_E)) * 0.3).astype(np.float32),
        value=np.zeros((SP_T, SP_E), np.float32),
        reward=rng.random((SP_T, SP_E)).astype(np.float32),
        done=(rng.random((SP_T, SP_E)) < 0.1).astype(np.float32),
        terminated=(rng.random((SP_T, SP_E)) < 0.05).astype(np.float32),
        final_obs=rng.random((SP_T, SP_E, 2)).astype(np.float32),
    )
    traj["terminated"] = np.minimum(traj["terminated"], traj["done"])
    return traj, rng.random((SP_E, 2)).astype(np.float32)


def _jax_params():
    jcfg = jimpala.ImpalaConfig(**dict(SP_CFG, hidden=(16,)))
    net = jimpala.make_network(make_jax_mdp(), jcfg)
    return jcfg, net, net.init(jax.random.key(0), jnp.zeros((1, 2)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: run_ranks results}: the seqpar case at W = 2 and 4, the sp
    update and train step cases at W = 4."""
    _, _, params = _jax_params()
    state = {f"param.{k}": v.numpy() for k, v in weights.from_flax(jax.device_get(params)).items()}
    traj, boot = _sp_traj()
    sp_in = dict(state, bootstrap_obs=boot, **{f"traj.{k}": v for k, v in traj.items()})
    out = {}
    for world in (2, 4):
        cases = [("scan", "seqpar", {}, _scan_inputs())]
        if world == 4:
            for layout in LAYOUTS:
                cases.append((f"update_{layout}", "sp_update", {"cfg": SP_CFG, "layout": layout},
                              sp_in))
                cases.append((f"train_{layout}", "sp_train",
                              {"cfg": TRAIN_CFG, "layout": layout, "iterations": 3}, {}))
        out[world] = run_ranks(world, cases, tmp_path_factory.mktemp(f"seqpar_w{world}"))
    return out


def _joined(results: list[dict], key: str) -> np.ndarray:
    return np.concatenate([r[key] for r in results], axis=0)


def _jax_fn(fn, world, n_sharded):
    return jseqpar.make_seqpar_fn(fn, jseqpar.make_sp_mesh(n_devices=world), n_sharded)


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_discounted_returns_match_jax_and_scan(ranks, world):
    x = _scan_inputs()
    got = _joined(ranks[world]["scan"], "disc")
    want = _jax_fn(jseqpar.seqpar_discounted_returns, world, 2)(
        jnp.asarray(x["rewards"]), jnp.asarray(x["dones"]), jnp.asarray(x["bootstrap"]), GAMMA)
    plain = returns.discounted_returns(*(torch.from_numpy(x[k]) for k in
                                         ("rewards", "dones", "bootstrap")), GAMMA)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_gae_matches_jax_and_scan(ranks, world):
    x = _scan_inputs()
    args = [x[k] for k in ("rewards", "values", "dones", "bootstrap")]
    adv_j, ret_j = _jax_fn(jseqpar.seqpar_gae, world, 3)(*map(jnp.asarray, args), GAMMA, LAM)
    adv_p, ret_p = returns.gae(*map(torch.from_numpy, args), GAMMA, LAM)
    for key, j, p in (("adv", adv_j, adv_p), ("ret", ret_j, ret_p)):
        got = _joined(ranks[world]["scan"], key)
        np.testing.assert_allclose(got, np.asarray(j), **TOL, err_msg=key)
        np.testing.assert_allclose(got, p.numpy(), **TOL, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_vtrace_matches_jax_and_scan(ranks, world):
    x = _scan_inputs()
    args = [x[k] for k in ("target_lp", "behav_lp", "rewards", "values", "dones", "bootstrap")]
    want = _jax_fn(jseqpar.seqpar_vtrace, world, 5)(*map(jnp.asarray, args), GAMMA, 1.0, 1.0, 0.9)
    plain = returns.vtrace(*map(torch.from_numpy, args), GAMMA, 1.0, 1.0, 0.9)
    for key, name in (("vs", "vs"), ("pg", "pg_advantages"), ("rho", "clipped_rhos")):
        got = _joined(ranks[world]["scan"], key)
        np.testing.assert_allclose(got, np.asarray(getattr(want, name)), **TOL, err_msg=name)
        np.testing.assert_allclose(got, getattr(plain, name).numpy(), **TOL, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_gae_no_dones_boundary(ranks, world):
    """All-zero dones: every segment's product is maximal, stressing the
    chain."""
    x = _scan_inputs()
    args = [x[f"nodones_{k}"] for k in ("rewards", "values", "dones", "bootstrap")]
    got = _joined(ranks[world]["scan"], "nodones_adv")
    adv_j, _ = _jax_fn(jseqpar.seqpar_gae, world, 3)(*map(jnp.asarray, args), GAMMA, LAM)
    adv_p, _ = returns.gae(*map(torch.from_numpy, args), GAMMA, LAM)
    np.testing.assert_allclose(got, np.asarray(adv_j), **TOL)
    np.testing.assert_allclose(got, adv_p.numpy(), **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_long_trajectory_many_segments(ranks, world):
    x = _scan_inputs()
    args = [x[f"long_{k}"] for k in ("rewards", "values", "dones", "bootstrap")]
    adv_j, ret_j = _jax_fn(jseqpar.seqpar_gae, world, 3)(*map(jnp.asarray, args), GAMMA, LAM)
    adv_p, ret_p = returns.gae(*(torch.from_numpy(np.asarray(a)) for a in args), GAMMA, LAM)
    for key, j, p in (("long_adv", adv_j, adv_p), ("long_ret", ret_j, ret_p)):
        got = _joined(ranks[world]["scan"], key)
        np.testing.assert_allclose(got, np.asarray(j), **LONG_TOL, err_msg=key)
        np.testing.assert_allclose(got, p.numpy(), **LONG_TOL, err_msg=key)


def _port_unsharded_update(params_np, traj, boot):
    cfg = timpala.ImpalaConfig(**dict(SP_CFG, hidden=(16,)))
    env = make_two_state_mdp()
    net = timpala.make_network(env, cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in params_np.items()})
    opt = timpala.make_optimizer(cfg)
    opt_state = opt.init(dict(net.named_parameters()))
    ttraj = tcommon.Transition(**{k: torch.from_numpy(v) for k, v in traj.items()})
    loss, metrics = timpala.impala_loss(net, ttraj, torch.from_numpy(boot), cfg, True)
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    opt.step(params, dict(zip(params, grads)), opt_state)
    return {k: p.detach().numpy() for k, p in net.named_parameters()}, metrics


@pytest.mark.parametrize("layout", LAYOUTS, ids=["sp4-1d", "sp2xdp2-2d"])
def test_sp_update_matches_unsharded_and_jax(ranks, layout):
    jcfg, jnet, params = _jax_params()
    traj, boot = _sp_traj()
    params_np = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(params)).items()}
    want, want_metrics = _port_unsharded_update(params_np, traj, boot)

    jtraj = jcommon.Transition(**{k: jnp.asarray(v) for k, v in traj.items()})
    m = (jseqpar.make_sp_mesh(n_devices=4) if layout == "1d"
         else jax.make_mesh((2, 2), (jseqpar.SP_AXIS, "dp")))
    jupdate = jimpala.make_sp_update(make_jax_mdp(), jcfg, m,
                                     dp_axis_name=None if layout == "1d" else "dp")
    opt = jimpala.make_optimizer(jcfg)
    jparams, _, jmetrics = jupdate(params, opt.init(params), jtraj, jnp.asarray(boot))
    jax_params = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(jparams)).items()}

    results = ranks[4][f"update_{layout}"]
    for r, res in enumerate(results):
        for k, v in want.items():
            got = res[f"param.{k}"]
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(got, jax_params[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k} (JAX)")
            np.testing.assert_array_equal(got, results[0][f"param.{k}"])
        for k in ("loss", "mean_rho"):
            np.testing.assert_allclose(res[f"metric.{k}"], float(want_metrics[k]), rtol=1e-5)
            np.testing.assert_allclose(res[f"metric.{k}"], float(jmetrics[k]), rtol=1e-5)
    # The update moved the parameters.
    assert not np.allclose(want["torso.dense_0.weight"], params_np["torso.dense_0.weight"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=["sp4-1d", "sp2xdp2-2d"])
def test_sp_train_step_matches_reference(ranks, layout):
    """Three iterations of `make_sp_train_step` against the step the layout
    must equal, each rank from the same state: the single-device step
    (sp4) or the dp step over the mesh's dp groups (sp2 × dp2)."""
    for r, res in enumerate(ranks[4][f"train_{layout}"]):
        ref = {k[len("ref."):]: v for k, v in res.items() if k.startswith("ref.")}
        sp = {k[len("sp."):]: v for k, v in res.items() if k.startswith("sp.")}
        assert sorted(ref) == sorted(sp)
        assert sp["state.step_counter"].tolist() == [3]
        for k in ref:
            if k.startswith(("state.param", "state.actor_net")):
                np.testing.assert_allclose(sp[k], ref[k], rtol=2e-4, atol=1e-5,
                                           err_msg=f"rank {r} {k}")
        for k in ("loss", "mean_rho", "avg_return_ema", "mean_finished_return",
                  "mean_ep_length"):
            np.testing.assert_allclose(sp[f"metric.{k}"], ref[f"metric.{k}"], rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
        # The rollout, the episode accounting and the generator are the
        # reference's: the sp step changes only the learner's scan.
        for k in ("state.rollout obs", "state.ep_return", "state.ep_length"):
            np.testing.assert_array_equal(sp[k], ref[k], err_msg=f"rank {r} {k}")


def test_seqpar_without_a_group_is_the_plain_scan():
    x = {k: torch.from_numpy(v) for k, v in _scan_inputs().items()}
    r, v, d, b = x["rewards"], x["values"], x["dones"], x["bootstrap"]
    for got, want in zip(seqpar.seqpar_gae(r, v, d, b, GAMMA, LAM, group=None),
                         returns.gae(r, v, d, b, GAMMA, LAM)):
        assert torch.equal(got, want)
    np.testing.assert_allclose(seqpar.seqpar_discounted_returns(r, d, b, GAMMA, group=None),
                               returns.discounted_returns(r, d, b, GAMMA), **TOL)
    got = seqpar.seqpar_vtrace(x["target_lp"], x["behav_lp"], r, v, d, b, GAMMA, 1.0, 1.0, 0.9,
                               group=None)
    want = returns.vtrace(x["target_lp"], x["behav_lp"], r, v, d, b, GAMMA, 1.0, 1.0, 0.9)
    for name in ("vs", "pg_advantages", "clipped_rhos"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), **TOL, err_msg=name)
    # The reference segment scan: B from zero, P the suffix products.
    a = GAMMA * LAM * (1.0 - d)
    B, P = seqpar._local_affine_scan(a, r)
    np.testing.assert_allclose(B, returns.gae(r, torch.zeros_like(r), d, torch.zeros(E),
                                              GAMMA, LAM)[0], **TOL)
    np.testing.assert_allclose(P[0], torch.prod(a, 0), **TOL)
