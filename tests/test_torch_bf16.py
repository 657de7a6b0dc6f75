"""The port's bf16 compute (`bf16_compute`, `--update-dtype bf16`) against
the JAX package's `compute_dtype=jnp.bfloat16` networks and trainers, from
the same parameters (converted by `weights.from_flax`) and the same inputs,
on the CPU. Each comparison prints its count of bitwise mismatches.

Tolerances, with their reasons:
- forward of the MLP nets: atol 1e-6 (rtol 0). Both sides round the
  product, the bias add and the activation to bf16 op by op, from a
  float32-accumulated product (measured: 1 of 16,384 torso elements
  differs, by 9.5e-7; the off-policy actor's float32 tanh of a bf16 head
  differs by float32 ulps, XLA's tanh being its own approximation).
- the Nature CNN torso: bitwise. Its uint8 scaling in bf16: bitwise over
  all 256 byte values.
- heads over the CNN's 512 features, and anything computed from a bf16
  quantity: one bf16 ulp of the value (2^-7 of its binade; `BF16_ULP`).
  The 512-term float32 sums of the two libraries round to different bf16
  neighbours now and then (measured: 1 of 32 values).
- gradients: every element within 2% of the network's largest gradient
  magnitude, the whole gradient within 1% relative L2 (`GRAD_SHARE`,
  `GRAD_REL_L2`). The backward's bf16 products round in other places on
  the two sides (torch's tanh/ReLU backward rounds once, XLA's chain rounds
  each product), and a bias's gradient, a sum over the batch that cancels,
  keeps the difference of its terms (measured: worst 0.84% of the largest
  gradient, relative L2 0.47%; the Nature CNN's weight gradients bitwise).
- one update: losses and metrics at rtol 2e-2 + atol 1e-3 (bf16 carries 8
  significant bits); the parameters after it within 0.5·lr each and the
  whole update (new − old) within 2% relative L2 of JAX's (`STEP_MAX`,
  `STEP_REL_L2`). Adam's first steps move a parameter by about lr·g/|g|,
  so a gradient element within its bf16 error of 0 moves the step by up
  to 2·lr; measured: worst 0.20·lr (PPO's four steps), relative L2 at most
  0.29%.
- eval parity on the point mass (`tests/test_bf16.py`'s legs, slow): PPO
  and IMPALA both legs > -1.0 and |fp32 - bf16| < 1.0; A2C |fp32 - bf16| <
  1.0 only, since JAX's own fp32 A2C leg reaches -3.73 (bf16 -3.81) and
  fails its > -1.0 bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import a2c as ja2c
from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.algos import impala as jimpala
from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.envs import make_cartpole as make_jax_cartpole
from actor_critic_tpu.envs import make_pong as make_jax_pong
from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec
from actor_critic_tpu.models import networks as jnets
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import a2c as ta2c
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.algos import impala as timpala
from actor_critic_tpu_torch.algos import ppo as tppo
from actor_critic_tpu_torch.envs import EnvSpec, make_cartpole, make_point_mass, make_pong
from actor_critic_tpu_torch.models import networks as tnets
from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

BF = jnp.bfloat16
TBF = torch.bfloat16
MLP_ATOL = 1e-6
GRAD_SHARE = 2e-2   # of the network's largest gradient magnitude, any element
GRAD_REL_L2 = 1e-2  # the whole gradient's relative L2 difference
METRIC_TOL = dict(rtol=2e-2, atol=1e-3)
STEP_REL_L2 = 2e-2  # the whole update's (new − old) relative L2 difference
STEP_MAX = 0.5      # of lr, any parameter after the update
OBS, ACT, NUM_ACTIONS, PX = 17, 6, 3, 42


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, exp = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, exp - 8)


def _mismatches(name: str, got, want) -> tuple[int, float]:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    n, worst = int(np.count_nonzero(d)), float(d.max(initial=0.0))
    print(f"{name}: {n} of {d.size} differ, max {worst:.3e}")
    return n, worst


def _inputs(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(n, OBS)).astype(np.float32),
        act=rng.uniform(-1, 1, size=(n, ACT)).astype(np.float32),
        px=rng.integers(0, 256, size=(32, PX, PX, 2), dtype=np.uint8),
    )


def _dist_fields(out):
    """The float arrays a network's output carries, by name."""
    if isinstance(out, tuple) and len(out) == 2 and not hasattr(out, "_fields"):
        dist, other = out
        fields = _dist_fields(dist)
        fields.update({f"second.{k}": v for k, v in _dist_fields(other).items()})
        return fields
    for names in (("logits",), ("mean", "log_std")):
        if all(hasattr(out, k) for k in names):
            return {k: getattr(out, k) for k in names}
    return {"out": out}


# name -> (flax module, port module, input names, tolerance kind)
NETS = {
    "MLPTorso": (lambda: jnets.MLPTorso((64, 64), compute_dtype=BF),
                 lambda: tnets.MLPTorso(OBS, (64, 64), compute_dtype=TBF), ("obs",), "mlp"),
    "NatureCNN": (lambda: jnets.NatureCNN(compute_dtype=BF),
                  lambda: tnets.NatureCNN((PX, PX, 2), compute_dtype=TBF), ("px",), "bitwise"),
    "ActorCriticDiscrete": (
        lambda: jnets.ActorCriticDiscrete(num_actions=NUM_ACTIONS, compute_dtype=BF),
        lambda: tnets.ActorCriticDiscrete(OBS, NUM_ACTIONS, compute_dtype=TBF), ("obs",), "mlp"),
    "ActorCriticDiscrete-pixel": (
        lambda: jnets.ActorCriticDiscrete(num_actions=NUM_ACTIONS, pixel_obs=True,
                                          compute_dtype=BF),
        lambda: tnets.ActorCriticDiscrete((PX, PX, 2), NUM_ACTIONS, pixel_obs=True,
                                          compute_dtype=TBF), ("px",), "ulp"),
    "ActorCriticGaussian": (
        lambda: jnets.ActorCriticGaussian(action_dim=ACT, compute_dtype=BF),
        lambda: tnets.ActorCriticGaussian(OBS, ACT, compute_dtype=TBF), ("obs",), "mlp"),
    "DeterministicActor": (
        lambda: jnets.DeterministicActor(action_dim=ACT, compute_dtype=BF),
        lambda: tnets.DeterministicActor(OBS, ACT, compute_dtype=TBF), ("obs",), "mlp"),
    "SquashedGaussianActor": (
        lambda: jnets.SquashedGaussianActor(action_dim=ACT, compute_dtype=BF),
        lambda: tnets.SquashedGaussianActor(OBS, ACT, compute_dtype=TBF), ("obs",), "mlp"),
    "QFunction": (lambda: jnets.QFunction(compute_dtype=BF),
                  lambda: tnets.QFunction(OBS, ACT, compute_dtype=TBF), ("obs", "act"), "mlp"),
    "TwinQ": (lambda: jnets.TwinQ(compute_dtype=BF),
              lambda: tnets.TwinQ(OBS, ACT, compute_dtype=TBF), ("obs", "act"), "mlp"),
}


def _net_pair(name, seed=0):
    jmake, tmake, names, kind = NETS[name]
    x = _inputs(seed)
    args = [x[k] for k in names]
    jnet, tnet = jmake(), tmake()
    params = jnet.init(jax.random.key(seed), *[jnp.asarray(a) for a in args])
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    return jnet, params, tnet, args, kind


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_flax_bf16(name):
    """Each of the nine networks in bf16 against flax's with
    `compute_dtype=jnp.bfloat16`: the torsos hand bf16 on, the heads hand
    float32 out (cast up where JAX casts), the parameters stay float32."""
    jnet, params, tnet, args, kind = _net_pair(name)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    jout = jnet.apply(params, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        tout = tnet(*[torch.from_numpy(a) for a in args])
    jf, tf = _dist_fields(jout), _dist_fields(tout)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        want_dtype = TBF if name in ("MLPTorso", "NatureCNN") else torch.float32
        assert tf[k].dtype == want_dtype, (name, k, tf[k].dtype)
        got, want = tf[k].detach().float().numpy(), np.asarray(jf[k].astype(jnp.float32))
        _mismatches(f"{name} {k}", got, want)
        if kind == "bitwise":
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {k}")
        elif kind == "ulp":
            assert np.all(np.abs(got - want) <= bf16_ulp(want)), (name, k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=MLP_ATOL, err_msg=f"{name} {k}")


def test_uint8_scaling_is_bitwise_for_every_byte():
    """`x.bfloat16() / 255.0` against JAX's `x.astype(bf16) / 255.0` over all
    256 byte values, eager and jitted into the Nature CNN's first op."""
    b = np.arange(256, dtype=np.uint8)
    ours = (torch.from_numpy(b).to(TBF) / 255.0).float().numpy()
    theirs = np.asarray((jnp.asarray(b).astype(BF) / 255.0).astype(jnp.float32))
    n, _ = _mismatches("uint8 / 255 in bf16", ours, theirs)
    assert n == 0


def test_bf16_net_is_not_the_fp32_net():
    """The dtype reaches the torso (no path quietly runs float32): the same
    parameters give other values in bf16 than in float32, and the float32
    module computes with the plain nn.Linear call."""
    x = torch.from_numpy(_inputs(3)["obs"])
    fp32 = tnets.ActorCriticDiscrete(OBS, NUM_ACTIONS, generator=torch.Generator().manual_seed(0))
    bf16 = tnets.ActorCriticDiscrete(OBS, NUM_ACTIONS, generator=torch.Generator().manual_seed(0),
                                     compute_dtype=TBF)
    assert bf16.torso(x).dtype == TBF and fp32.torso(x).dtype == torch.float32
    with torch.no_grad():
        (d32, v32), (d16, v16) = fp32(x), bf16(x)
        np.testing.assert_array_equal(
            d32.logits.numpy(),
            fp32.policy(fp32.torso(x)).numpy())
    assert not torch.equal(v32, v16)
    assert float((v32 - v16).abs().max()) < 0.05


def test_shared_casts_keep_the_bits_and_the_gradient():
    """`shared_casts` (a rollout's forwards reading one set of bf16 weight
    copies): the same outputs bit for bit as casting in each forward, for
    the MLP and the CNN nets; a forward with autograd inside the block
    still casts anew, so its gradient reaches the float32 weights; the
    copies are gone after the block; float32 nets are untouched."""
    for name in ("ActorCriticDiscrete", "ActorCriticDiscrete-pixel", "TwinQ"):
        _, _, tnet, args, _ = _net_pair(name)
        x = [torch.from_numpy(a) for a in args]
        with torch.no_grad():
            plain = _dist_fields(tnet(*x))
            with tnets.shared_casts(tnet):
                assert any("_shared_casts" in m.__dict__ for m in tnet.modules())
                shared = _dist_fields(tnet(*x))
        assert not any("_shared_casts" in m.__dict__ for m in tnet.modules())
        for k in plain:
            assert torch.equal(plain[k], shared[k]), (name, k)
        with tnets.shared_casts(tnet):
            out = _dist_fields(tnet(*x))
            torch.sum(sum(v.float().sum() for v in out.values())).backward()
        assert all(p.grad is not None and p.grad.abs().sum() > 0
                   for n, p in tnet.named_parameters() if n.endswith("weight")), name
    fp32 = tnets.ActorCriticDiscrete(OBS, NUM_ACTIONS)
    with tnets.shared_casts(fp32):
        assert not any("_shared_casts" in m.__dict__ for m in fp32.modules())


# ------------------------------------------------------------ gradients


def _flat_np(d: dict) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in sorted(d.items())])


def _grads_close(tgrads: dict, jgrads: dict, label: str) -> None:
    """Every gradient float32; each element within `GRAD_SHARE` of the
    network's largest gradient magnitude, the whole within `GRAD_REL_L2`."""
    assert sorted(tgrads) == sorted(jgrads)
    assert all(g.dtype == torch.float32 for g in tgrads.values())
    got = {k: g.numpy() for k, g in tgrads.items()}
    for k in jgrads:
        _mismatches(f"{label} grad {k}", got[k], jgrads[k])
    g, w = _flat_np(got), _flat_np(jgrads)
    worst, rel = float(np.abs(g - w).max()), float(np.linalg.norm(g - w) / np.linalg.norm(w))
    print(f"{label}: worst {worst / np.abs(w).max():.4f} of the largest gradient, "
          f"relative L2 {rel:.4f}")
    assert worst <= GRAD_SHARE * float(np.abs(w).max()), (label, worst)
    assert rel <= GRAD_REL_L2, (label, rel)


@pytest.mark.parametrize("pixel", [False, True], ids=["mlp", "pixel"])
def test_a2c_grads_match_jax_at_bf16_level(pixel):
    """A2C's loss and gradients through the bf16 net (the MLP over 17 obs,
    and the Nature CNN at 42 px), against JAX's."""
    rng = np.random.default_rng(5)
    T, E = 4, 8
    jcfg, cfg = ja2c.A2CConfig(bf16_compute=True), ta2c.A2CConfig(bf16_compute=True)
    if pixel:
        jenv, tenv = make_jax_pong(size=PX), make_pong(size=PX)
        obs = np.where(rng.random((T, E, PX, PX, 2)) < 0.06, 255, 0).astype(np.uint8)
        jnet = ja2c.make_network(jenv, jcfg)
        params = jnet.init(jax.random.key(1), jnp.zeros((1, PX, PX, 2), jnp.uint8))
        tnet = ta2c.make_network(tenv, cfg)
        A = 3
    else:
        spec = JaxEnvSpec(obs_shape=(OBS,), action_dim=NUM_ACTIONS, discrete=True)
        jnet = jppo.make_network(spec, jppo.PPOConfig(bf16_compute=True))
        params = jnet.init(jax.random.key(1), jnp.zeros((1, OBS), jnp.float32))
        tnet = tppo.make_network(EnvSpec(obs_shape=(OBS,), action_dim=NUM_ACTIONS, discrete=True),
                                 tppo.PPOConfig(bf16_compute=True))
        obs = rng.normal(size=(T, E, OBS)).astype(np.float32)
        A = NUM_ACTIONS
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    b = dict(obs=obs, action=rng.integers(0, A, size=(T, E)).astype(np.int32),
             log_prob=np.full((T, E), -1.0, np.float32),
             value=rng.normal(size=(T, E)).astype(np.float32),
             reward=np.ones((T, E), np.float32), done=np.zeros((T, E), np.float32),
             terminated=np.zeros((T, E), np.float32), final_obs=obs)
    adv = rng.normal(size=(T, E)).astype(np.float32)
    ret = (3.0 * rng.normal(size=(T, E))).astype(np.float32)
    jtraj = jcommon.Transition(**{k: jnp.asarray(v) for k, v in b.items()})
    (jloss, jaux), jgrads = jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        params, jnet.apply, jtraj, jnp.asarray(adv), jnp.asarray(ret), jcfg)
    ttraj = tcommon.Transition(**{k: torch.from_numpy(v) for k, v in b.items()})
    tloss, taux = ta2c.a2c_loss(tnet, ttraj, torch.from_numpy(adv), torch.from_numpy(ret), cfg)
    tparams = dict(tnet.named_parameters())
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss, list(tparams.values()))))
    assert tloss.dtype == torch.float32
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **METRIC_TOL, err_msg=k)
    jg = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(jgrads)).items()}
    _grads_close(tgrads, jg, "pixel" if pixel else "mlp")


# ------------------------------------------------------------ one update


def _assert_step_close(label, got: dict, want: dict, before: dict, lr: float,
                       moved: bool = True) -> None:
    """The parameters after an update against JAX's: the whole update (new −
    old) within `STEP_REL_L2` relative L2, each parameter within
    `STEP_MAX`·lr; with `moved`, every tensor moved."""
    got = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in got.items()}
    for k in want:
        _mismatches(f"{label} {k}", got[k], want[k])
        if moved:
            assert not np.array_equal(got[k], before[k]), (label, k, "did not move")
    g, w, b = _flat_np(got), _flat_np(want), _flat_np(before)
    worst = float(np.abs(g - w).max()) / lr
    rel = float(np.linalg.norm((g - b) - (w - b)) / np.linalg.norm(w - b))
    print(f"{label}: worst {worst:.4f}·lr, the update's relative L2 difference {rel:.4f}")
    assert worst <= STEP_MAX, (label, worst)
    assert rel <= STEP_REL_L2, (label, rel)


def _np_params(module) -> dict:
    return {k: p.detach().numpy().copy() for k, p in module.named_parameters()}


def test_a2c_update_matches_jax():
    """One bf16 A2C update on a rollout JAX's bf16 net collected on CartPole
    (E=16, T=8), against the update `make_train_step` composes."""
    kw = dict(num_envs=16, rollout_steps=8, lr=1e-3, entropy_coef=0.01, bf16_compute=True)
    jcfg, cfg = ja2c.A2CConfig(**kw), ta2c.A2CConfig(**kw)
    jenv, tenv = make_jax_cartpole(), make_cartpole()
    jstate = ja2c.init_state(jenv, jcfg, jax.random.key(0))
    jnet = ja2c.make_network(jenv, jcfg)
    new_rollout, jtraj = jcommon.rollout_scan(
        jenv, jnet.apply, jstate.params, jstate.rollout, jax.random.key(1), 8)
    for _ in range(2):
        new_rollout, jtraj = jcommon.rollout_scan(
            jenv, jnet.apply, jstate.params, new_rollout, jax.random.key(2), 8)
    assert jtraj.value.dtype == jnp.float32 and jtraj.log_prob.dtype == jnp.float32
    apply, params = jnet.apply, jstate.params
    _, boot = apply(params, new_rollout.obs)
    _, fv = apply(params, jtraj.final_obs.reshape(8 * 16, 4))
    rewards = jcommon.truncation_bootstrap_rewards(jtraj, fv.reshape(8, 16), jcfg.gamma)
    adv, ret = jcommon.gae_targets(rewards, jtraj.value, jtraj.done, boot,
                                   jcfg.gamma, jcfg.gae_lambda)
    (_, jmetrics), grads = jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        params, apply, jtraj, adv, ret, jcfg, None, ja2c.entropy_coef_at(jcfg, 0))
    opt = ja2c.make_optimizer(jcfg)
    updates, _ = opt.update(grads, jstate.opt_state, params)
    new_params = jax.tree.map(lambda p, u: p + u, params, updates)

    tnet = ta2c.make_network(tenv, cfg)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    before = _np_params(tnet)
    topt = ta2c.make_optimizer(cfg)
    tstate = tcommon.TrainState(
        net=tnet, opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None,
                                     obs=torch.from_numpy(np.array(new_rollout.obs))),
        generator=torch.Generator(),
        ep_return=torch.zeros(16), ep_length=torch.zeros(16), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64), schedule=ta2c.make_schedule(cfg))
    ttraj = tcommon.Transition(*(torch.from_numpy(np.array(x)) for x in jtraj))
    tmetrics = ta2c.update(tenv, cfg, topt, tstate, ttraj)
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **METRIC_TOL, err_msg=k)
    want = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(new_params)).items()}
    _assert_step_close("a2c", dict(tnet.named_parameters()), want, before, cfg.lr)


def _ppo_jax_permutations(key, epochs, B):
    return np.stack([np.asarray(jax.random.permutation(k, B))
                     for k in jax.random.split(key, epochs)])


def test_ppo_update_matches_jax():
    """One bf16 PPO iteration (2 epochs × 2 minibatches, E=16, T=8) on the
    rollout JAX's jitted bf16 `make_train_step` collects, with its
    permutations, against the parameters and metrics that step returns."""
    kw = dict(num_envs=16, rollout_steps=8, epochs=2, num_minibatches=2, lr=1e-3,
              entropy_coef=0.01, bf16_compute=True)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    jenv, tenv = make_jax_cartpole(), make_cartpole()
    jstate = jppo.init_state(jenv, jcfg, jax.random.key(0))
    new_jstate, jmetrics = jax.jit(jppo.make_train_step(jenv, jcfg))(jstate)
    jnet = jppo.make_network(jenv.spec, jcfg)
    _, rkey, ukey = jax.random.split(jstate.key, 3)
    new_rollout, jtraj = jcommon.rollout_scan(
        jenv, jnet.apply, jstate.params, jstate.rollout, rkey, cfg.rollout_steps)
    B = cfg.num_envs * cfg.rollout_steps
    tnet = tppo.make_network(tenv.spec, cfg)
    tnet.load_state_dict(weights.from_flax(jax.device_get(jstate.params)))
    before = _np_params(tnet)
    topt = tppo.make_optimizer(cfg)
    tstate = tcommon.TrainState(
        net=tnet, opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None,
                                     obs=torch.from_numpy(np.array(new_rollout.obs))),
        generator=torch.Generator(),
        ep_return=torch.zeros(16), ep_length=torch.zeros(16), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64), schedule=tppo.make_schedule(cfg))
    ttraj = tcommon.Transition(*(torch.from_numpy(np.array(x)) for x in jtraj))
    tmetrics = tppo.update(tenv, cfg, topt, tstate, ttraj,
                           perms=torch.from_numpy(_ppo_jax_permutations(ukey, cfg.epochs, B)))
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **METRIC_TOL,
                                   err_msg=k)
    want = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(new_jstate.params)).items()}
    _assert_step_close("ppo", dict(tnet.named_parameters()), want, before, cfg.lr)
    for k, t in tstate.opt_state.mu.items():
        assert t.dtype == torch.float32 and tstate.opt_state.nu[k].dtype == torch.float32


def test_impala_update_matches_jax():
    """One bf16 IMPALA update (V-trace, RMSProp) on a fixed pixel rollout
    at 36 px, E=T=4, against the update `make_train_step` composes. RMSProp
    moves a parameter by ~lr·g/√ε (ε = 0.1 inside the root), so the
    parameters agree to the gradients' bf16 share scaled by that."""
    size, T, E = 36, 4, 4
    kw = dict(num_envs=E, rollout_steps=T, lr=1e-3, actor_refresh_every=1, bf16_compute=True)
    jcfg, cfg = jimpala.ImpalaConfig(**kw), timpala.ImpalaConfig(**kw)
    jnet = jimpala.make_network(make_jax_pong(size=size), jcfg)
    params = jnet.init(jax.random.key(3), jnp.zeros((1, size, size, 2), jnp.uint8))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 60.0 if "policy" in jax.tree_util.keystr(path) else x, params)
    rng = np.random.default_rng(4)
    frames = lambda *shape: np.where(rng.random(shape) < 0.06, 255, 0).astype(np.uint8)
    done = (rng.random((T, E)) < 0.3).astype(np.float32)
    b = dict(obs=frames(T, E, size, size, 2),
             action=rng.integers(0, 3, size=(T, E)).astype(np.int32),
             log_prob=(np.log(1 / 3) + rng.normal(scale=0.4, size=(T, E))).astype(np.float32),
             value=rng.normal(size=(T, E)).astype(np.float32),
             reward=rng.choice([-1.0, 0.0, 1.0], size=(T, E)).astype(np.float32),
             done=done, terminated=(done * (rng.random((T, E)) < 0.5)).astype(np.float32),
             final_obs=frames(T, E, size, size, 2))
    boot = frames(E, size, size, 2)
    jtraj = jcommon.Transition(**{k: jnp.asarray(v) for k, v in b.items()})
    (_, jmetrics), grads = jax.value_and_grad(jimpala.impala_loss, has_aux=True)(
        params, jnet.apply, jtraj, jnp.asarray(boot), jcfg, True)
    jopt = jimpala.make_optimizer(jcfg)
    updates, _ = jopt.update(grads, jopt.init(params), params)
    new_params = jax.tree.map(lambda p, u: p + u, params, updates)

    def net():
        n = timpala.make_network(make_pong(size=size), cfg)
        n.load_state_dict(weights.from_flax(jax.device_get(params)))
        return n

    tnet = net()
    before = _np_params(tnet)
    topt = timpala.make_optimizer(cfg)
    state = timpala.ImpalaTrainState(
        net=tnet, opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None, obs=torch.from_numpy(boot)),
        generator=torch.Generator(),
        ep_return=torch.zeros(E), ep_length=torch.zeros(E), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64), actor_net=net())
    tmetrics = timpala.update(make_pong(size=size), cfg, topt, state,
                              tcommon.Transition(**{k: torch.from_numpy(v) for k, v in b.items()}))
    for k in ("loss", "pg_loss", "v_loss", "entropy", "mean_rho"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **METRIC_TOL, err_msg=k)
    want = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(new_params)).items()}
    _assert_step_close("impala", dict(tnet.named_parameters()), want, before, cfg.lr)


def _offpolicy_update(label: str, mod_name: str, case_kw: dict):
    """Two bf16 updates of a DDPG/TD3 or SAC learner against JAX's
    `one_update` with its draws (tests/test_torch_ddpg.py's and
    test_torch_sac.py's parity, in bf16)."""
    import importlib

    from torch_offpolicy_states import ddpg_draws, learner_tensors, max_differences, sac_draws

    t = importlib.import_module(f"test_torch_{mod_name}")
    cfg_kw = t._small(updates_per_iter=1, bf16_compute=True, **case_kw)
    jcfg, jls = t._jax_learner(cfg_kw)
    cfg, port = t._port_learner(cfg_kw, jls)
    jmod, tmod = (t.jddpg, t.tddpg) if mod_name == "ddpg" else (t.jsac, t.tsac)
    jloop = jax.jit(jmod.make_update_loop(t.ACT, jcfg))
    tloop = tmod.make_update_loop(t.ACT, cfg)
    lr = cfg.critic_lr
    for step in range(2):
        before = {k: v.numpy().copy() for k, v in learner_tensors(port).items()}
        if mod_name == "ddpg":
            draws = tmod.UpdateDraws(*ddpg_draws(jls, jcfg, t.ACT))
        else:
            draws = tmod.SACDraws(*sac_draws(jls, jcfg, t.ACT))
        tm = tloop.apply_update(port, torch.tensor(True), draws)
        jls, jm = jloop(jls, jnp.asarray(True))
        _, want = t._port_learner(cfg_kw, jls)
        got_t, want_t = learner_tensors(port), learner_tensors(want)
        for k in ("critic_loss", "actor_loss", "q_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL, err_msg=k)
        diffs = max_differences(got_t, want_t)
        for name, d in diffs.items():
            assert got_t[name].dtype == want_t[name].dtype, name
            if got_t[name].is_floating_point():
                assert got_t[name].dtype == torch.float32, name
            if " count" in name or name.endswith(("update_count", "insert_pos", "size")) or (
                    "storage" in name):
                assert d == 0.0, (name, d)
        params = [k for k in got_t if got_t[k].is_floating_point() and " mu " not in k
                  and " nu " not in k and "replay" not in k]
        _assert_step_close(f"{label} step {step}", {k: got_t[k] for k in params},
                           {k: want_t[k].numpy() for k in params},
                           {k: before[k] for k in params}, lr, moved=False)


@pytest.mark.parametrize("case", ["ddpg", "td3", "sac"])
def test_offpolicy_update_matches_jax(case):
    """DDPG, TD3 (twin critics, target smoothing, delay 2) and SAC: two bf16
    updates each, parameters, targets and Adam state float32, every step
    within the bf16 step bound of JAX's."""
    if case == "sac":
        _offpolicy_update(case, "sac", {})
    else:
        _offpolicy_update(case, "ddpg", {} if case == "ddpg" else dict(
            twin_q=True, policy_delay=2, target_noise=0.2))


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "gaussian"])
def test_host_ppo_update_matches_jax(discrete):
    """One bf16 host PPO update (2 epochs × 4 minibatches, T=16, E=4) on a
    block whose behaviour log-probs, values and bootstraps came from the
    float32 mirror (JAX's default overlap): the bf16 update recomputes the
    log-probs it clips against, as JAX's does."""
    A = 3 if discrete else 2
    jspec = JaxEnvSpec(obs_shape=(4,), action_dim=A, discrete=discrete)
    spec = EnvSpec(obs_shape=(4,), action_dim=A, discrete=discrete)
    kw = dict(num_envs=4, rollout_steps=16, epochs=2, num_minibatches=4, hidden=(16, 16),
              lr=1e-3, entropy_coef=0.01, bf16_compute=True)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    params, jopt_state = jppo.init_host_params(jspec, jcfg, jax.random.key(1))
    net = tppo.make_network(spec, cfg)
    net.load_state_dict(weights.from_flax(jax.device_get(params)))
    assert net.compute_dtype == TBF
    before = _np_params(net)
    opt_state = tppo.make_optimizer(cfg).init(dict(net.named_parameters()))
    rng = np.random.default_rng(7)
    T, E = 16, 4
    obs = rng.normal(size=(T, E, 4)).astype(np.float32)
    done = (rng.random((T, E)) < 0.15).astype(np.float32)
    b = dict(obs=obs,
             action=(rng.integers(0, A, (T, E)).astype(np.int32) if discrete
                     else rng.normal(size=(T, E, A)).astype(np.float32)),
             log_prob=((np.log(1 / A) + 0.3 * rng.normal(size=(T, E))) if discrete
                       else (-2.0 + 0.5 * rng.normal(size=(T, E)))).astype(np.float32),
             value=rng.normal(size=(T, E)).astype(np.float32),
             reward=rng.normal(size=(T, E)).astype(np.float32), done=done,
             terminated=(done * (rng.random((T, E)) < 0.5)).astype(np.float32),
             final_obs=(obs + 0.1).astype(np.float32),
             last_obs=rng.normal(size=(E, 4)).astype(np.float32),
             final_values=rng.normal(size=(T, E)).astype(np.float32),
             bootstrap_value=rng.normal(size=(E,)).astype(np.float32))
    key = jax.random.key(33)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params, jopt_state, jm = jppo.make_host_update_step(jspec, jcfg)(
        params, jopt_state, jb["obs"], jb["action"], jb["log_prob"], jb["value"],
        jb["reward"], jb["done"], jb["terminated"], jb["final_obs"], jb["last_obs"], key,
        final_values=jb["final_values"], bootstrap_value=jb["bootstrap_value"],
        progress=jnp.asarray(0.0, jnp.float32))
    perms = torch.from_numpy(_ppo_jax_permutations(key, 2, T * E))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tm = tppo.make_host_update_fn(spec, cfg)(
        net, opt_state, tppo.make_schedule(cfg), tb["obs"], tb["action"], tb["log_prob"],
        tb["value"], tb["reward"], tb["done"], tb["terminated"], tb["final_obs"],
        tb["last_obs"], perms, final_values=tb["final_values"],
        bootstrap_value=tb["bootstrap_value"], iteration=torch.tensor([0]))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **METRIC_TOL, err_msg=k)
    want = {k: v.numpy() for k, v in weights.from_flax(jax.device_get(params)).items()}
    _assert_step_close(f"host ppo {'discrete' if discrete else 'gaussian'}",
                       dict(net.named_parameters()), want, before, cfg.lr)
    assert int(opt_state.count) == 8
    assert all(t.dtype == torch.float32 for t in (*opt_state.mu.values(), *opt_state.nu.values()))


# ------------------------------------------------------------ serving

SERVE_ARCHS = ("ppo-categorical", "ppo-gaussian", "td3", "sac")


def _serve_arch(name: str, bf16: bool):
    from actor_critic_tpu.algos import ddpg as jddpg
    from actor_critic_tpu.algos import sac as jsac
    from actor_critic_tpu.envs import make_pendulum as make_jax_pendulum
    from actor_critic_tpu_torch.algos import ddpg as tddpg
    from actor_critic_tpu_torch.algos import sac as tsac
    from actor_critic_tpu_torch.envs import make_pendulum

    kw = dict(hidden=(16, 16), bf16_compute=bf16)
    algo, jcfg, cfg = {
        "ppo-categorical": ("ppo", jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)),
        "ppo-gaussian": ("ppo", jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)),
        "td3": ("td3", jddpg.td3_config(**kw), tddpg.td3_config(**kw)),
        "sac": ("sac", jsac.SACConfig(**kw), tsac.SACConfig(**kw)),
    }[name]
    if name == "ppo-categorical":
        return algo, make_jax_cartpole().spec, jcfg, make_cartpole().spec, cfg
    return algo, make_jax_pendulum().spec, jcfg, make_pendulum().spec, cfg


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_served_bf16_act_matches_jax(name):
    """A policy whose config has `bf16_compute` serves the trainer's bf16
    greedy act: the engine's acts against the JAX engine's (its
    `make_greedy_act` through `make_network(spec, cfg)`) at every bucket
    size, discrete actions bitwise, continuous within MLP_ATOL; the act
    network is the bf16 one."""
    from actor_critic_tpu import serving as jserving
    from actor_critic_tpu_torch import serving

    algo, jspec, jcfg, spec, cfg = _serve_arch(name, bf16=True)
    jparams = jserving.init_params(jspec, jcfg, algo, seed=0)
    np_params = jax.tree.map(np.asarray, jax.device_get(jparams))
    buckets = (1, 2, 4, 8)
    jengine = jserving.PolicyEngine(jspec, jcfg, algo=algo, buckets=buckets)
    engine = serving.PolicyEngine(spec, cfg, algo=algo, buckets=buckets, device="cpu")
    assert engine._network().compute_dtype == TBF
    prepared = engine.prepare_params(np_params)
    assert engine.warm(prepared) == len(buckets)
    rng = np.random.default_rng(4)
    for n in (1, 3, 4, 7, 8):
        obs = (3.0 * rng.normal(size=(n, *spec.obs_shape))).astype(np.float32)
        ours = engine.act(prepared, obs)
        theirs = jengine.act(jengine.prepare_params(jparams), obs)
        _mismatches(f"served {name} n={n}", ours, theirs)
        if spec.discrete:
            np.testing.assert_array_equal(ours, theirs)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=MLP_ATOL)


@pytest.mark.parametrize("name", ["ppo-gaussian", "sac"])
def test_mirror_backend_stays_float32(name):
    """The `mirror` backend acts in float32 whatever the config says, as
    JAX's mirror does: a bf16 config's mirror acts equal the fp32 config's
    bitwise, and differ from the bf16 device act."""
    from actor_critic_tpu_torch import serving

    algo, _, _, spec, cfg16 = _serve_arch(name, bf16=True)
    _, _, _, _, cfg32 = _serve_arch(name, bf16=False)
    from actor_critic_tpu_torch.serving import engine as engine_mod

    params = engine_mod.init_params(spec, cfg16, algo, seed=2)
    obs = (3.0 * np.random.default_rng(5).normal(size=(6, *spec.obs_shape))).astype(np.float32)
    acts = {}
    for label, cfg, backend in (("mirror16", cfg16, "mirror"), ("mirror32", cfg32, "mirror"),
                                ("device16", cfg16, "device")):
        e = serving.PolicyEngine(spec, cfg, algo=algo, buckets=(8,), backend=backend, device="cpu")
        acts[label] = e.act(e.prepare_params(params), obs)
    np.testing.assert_array_equal(acts["mirror16"], acts["mirror32"])
    assert not np.array_equal(acts["mirror16"], acts["device16"])


# ------------------------------------------------------------ precision discipline


@pytest.mark.parametrize("mod,cfg,make_env", [
    (ta2c, ta2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,), bf16_compute=True),
     make_cartpole),
    (timpala, timpala.ImpalaConfig(num_envs=4, rollout_steps=4, hidden=(16,), bf16_compute=True),
     make_cartpole),
], ids=["a2c", "impala"])
def test_bf16_train_step_finite(mod, cfg, make_env):
    """tests/test_bf16.py's case: three bf16 train steps, finite loss, the
    parameters and the optimizer's state float32 throughout."""
    env = make_env()
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    assert state.net.compute_dtype == TBF
    step = mod.make_train_step(env, cfg)
    for _ in range(3):
        state, metrics = step(state)
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in state.net.parameters())
    opt = state.opt_state
    moments = [t for f in dataclasses.fields(opt) for t in
               (getattr(opt, f.name).values() if isinstance(getattr(opt, f.name), dict) else ())]
    assert moments and all(t.dtype == torch.float32 for t in moments)


class _ReductionDtypes(torch.overrides.TorchFunctionMode):
    """Records the dtype of every tensor handed to a reduction or a
    log/exp-family op while active."""

    NAMES = {"sum", "mean", "logsumexp", "log_softmax", "softmax", "amax", "amin", "max",
             "min", "var", "std", "norm", "prod", "cumsum", "log", "exp", "square"}

    def __init__(self):
        super().__init__()
        self.seen: list[tuple[str, torch.dtype]] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.NAMES:
            self.seen += [(name, a.dtype) for a in args if isinstance(a, torch.Tensor)]
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("algo", ["a2c", "ppo", "impala", "a3c", "sac"])
def test_no_bf16_tensor_reaches_a_reduction_or_a_scan(algo, monkeypatch):
    """One bf16 iteration of each trainer: every loss reduction, log and
    exp takes float32 (the heads cast up before them), and GAE and V-trace
    are handed float32 (their wrappers refuse anything else)."""
    from actor_critic_tpu_torch.algos import sac as tsac
    from actor_critic_tpu_torch.envs import make_pendulum

    scans: list[tuple[str, torch.dtype]] = []
    for mod, fn in ((gae_cuda, "gae"), (vtrace_cuda, "vtrace")):
        orig = getattr(mod, fn)

        def spy(*args, _orig=orig, _fn=fn, **kwargs):
            scans.extend((_fn, a.dtype) for a in args if isinstance(a, torch.Tensor))
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, fn, spy)
    if algo == "sac":
        mod, env = tsac, make_pendulum()
        cfg = tsac.SACConfig(num_envs=4, steps_per_iter=4, updates_per_iter=2, batch_size=16,
                             hidden=(16, 16), buffer_capacity=256, warmup_steps=8,
                             bf16_compute=True)
    else:
        mod = {"a2c": ta2c, "ppo": tppo, "impala": timpala, "a3c": timpala}[algo]
        env = make_pong(size=PX) if algo == "impala" else make_cartpole()
        kw = dict(num_envs=4, rollout_steps=4, bf16_compute=True)
        if algo == "a3c":
            kw["correction"] = "none"
        if algo == "ppo":
            kw.update(epochs=1, num_minibatches=2)
        cfg = {"a2c": ta2c.A2CConfig, "ppo": tppo.PPOConfig}.get(algo, timpala.ImpalaConfig)(**kw)
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    step = mod.make_train_step(env, cfg)
    if algo == "sac":
        state, _ = step(state)  # through the warm-up: the second iteration updates
    mode = _ReductionDtypes()
    with mode:
        state, metrics = step(state)
    assert bool(torch.isfinite(metrics["loss"] if "loss" in metrics else metrics["critic_loss"]))
    assert mode.seen, "no reduction was seen"
    bf16 = [name for name, dtype in mode.seen if dtype == TBF]
    assert not bf16, f"bf16 tensors reached {sorted(set(bf16))}"
    if algo != "sac":
        assert scans and all(dtype == torch.float32 for _, dtype in scans), scans
        assert {name for name, _ in scans} == {"vtrace" if algo == "impala" else "gae"}


@pytest.mark.parametrize("scan", ["gae", "vtrace"])
def test_scan_wrappers_refuse_bf16(scan):
    """A bf16 tensor handed to GAE or V-trace raises (no silent fall back)."""
    T, E = 4, 3
    x = torch.zeros(T, E, dtype=TBF)
    boot = torch.zeros(E)
    with pytest.raises(TypeError, match="float32"):
        if scan == "gae":
            gae_cuda.gae(x, torch.zeros(T, E), torch.zeros(T, E), boot, 0.99, 0.95)
        else:
            vtrace_cuda.vtrace(torch.zeros(T, E), torch.zeros(T, E), x, torch.zeros(T, E),
                               torch.zeros(T, E), boot, 0.99)


# ------------------------------------------------------------ eval parity (learning, slow)

PARITY_CFGS = {
    "ppo": (tppo, lambda bf16: tppo.PPOConfig(num_envs=32, rollout_steps=16, epochs=4,
                                              num_minibatches=2, lr=3e-3, hidden=(32, 32),
                                              bf16_compute=bf16), 120),
    "a2c": (ta2c, lambda bf16: ta2c.A2CConfig(num_envs=32, rollout_steps=16, lr=3e-3,
                                              hidden=(32, 32), bf16_compute=bf16), 200),
    "impala": (timpala, lambda bf16: timpala.ImpalaConfig(num_envs=32, rollout_steps=16, lr=3e-3,
                                                          hidden=(32, 32), bf16_compute=bf16),
               200),
}


def _train_and_eval(algo: str, bf16: bool) -> float:
    mod, make_cfg, iters = PARITY_CFGS[algo]
    env, cfg = make_point_mass(), make_cfg(bf16)
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    step = mod.make_train_step(env, cfg)
    for _ in range(iters):
        state, _ = step(state)
    return float(mod.make_eval_fn(env, cfg)(state, torch.Generator().manual_seed(99), 32, 16))


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_eval_parity_fp32_vs_bf16(algo):
    """tests/test_bf16.py's legs on the port's point mass: both precisions
    learn (> -1.0; random is about -6) and land within 1.0 of each other."""
    fp32, bf16 = _train_and_eval(algo, False), _train_and_eval(algo, True)
    print(f"{algo}: fp32 {fp32:.3f}, bf16 {bf16:.3f}")
    assert fp32 > -1.0 and bf16 > -1.0, (fp32, bf16)
    assert abs(fp32 - bf16) < 1.0, (fp32, bf16)


@pytest.mark.slow
def test_eval_parity_fp32_vs_bf16_a2c():
    """A2C's leg holds |fp32 - bf16| < 1.0 only: JAX's own A2C legs on this
    config reach -3.73 (fp32) and -3.81 (bf16), so tests/test_bf16.py's
    > -1.0 bar fails on the reference itself (its `[a2c]` case)."""
    fp32, bf16 = _train_and_eval("a2c", False), _train_and_eval("a2c", True)
    print(f"a2c: fp32 {fp32:.3f}, bf16 {bf16:.3f}")
    assert abs(fp32 - bf16) < 1.0, (fp32, bf16)
