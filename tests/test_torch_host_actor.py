"""The port's numpy mirrors (`actor_critic_tpu_torch/models/host_actor.py`)
against the JAX package's (`actor_critic_tpu/models/host_actor.py`): flax
parameters are converted into the port's modules (`weights.from_flax`),
the port snapshots them back into the mirror's tree (`mirror_params`,
`MirrorSnapshot`), and every mirror on that tree gives what the JAX mirror
gives on the flax tree, bit for bit, from the same numpy generator state:
PPO's policy (discrete and Gaussian), value and greedy act, DDPG's and
SAC's explore (in and past the warm-up) and greedy acts.

The layout is held too: each `kernel` is [in, out] float32 C-contiguous
and equal to flax's; a matmul against a transposed [out, in] view may
block differently in BLAS and stop being JAX's to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec
from actor_critic_tpu.models import host_actor as jmirror
from actor_critic_tpu.models.networks import (
    ActorCriticDiscrete as JDiscrete,
    ActorCriticGaussian as JGaussian,
    DeterministicActor as JDeterministic,
    SquashedGaussianActor as JSquashed,
)
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.envs import EnvSpec
from actor_critic_tpu_torch.models import host_actor
from actor_critic_tpu_torch.models.networks import (
    ActorCriticDiscrete,
    ActorCriticGaussian,
    DeterministicActor,
    SquashedGaussianActor,
)

OBS, ACT, N = 5, 3, 7


@dataclasses.dataclass
class Cfg:
    warmup_steps: int = 16
    exploration_noise: float = 0.1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _pair(kind, seed=0):
    """(flax params as numpy, the port module holding them)."""
    obs = jnp.zeros((1, OBS), jnp.float32)
    jax_net, port = {
        "discrete": (JDiscrete(num_actions=ACT, hidden=(16, 8)),
                     ActorCriticDiscrete(OBS, ACT, (16, 8))),
        "gaussian": (JGaussian(action_dim=ACT, hidden=(16, 8)),
                     ActorCriticGaussian(OBS, ACT, (16, 8))),
        "ddpg": (JDeterministic(action_dim=ACT, hidden=(16, 8)),
                 DeterministicActor(OBS, ACT, (16, 8))),
        "sac": (JSquashed(action_dim=ACT, hidden=(16, 8)),
                SquashedGaussianActor(OBS, ACT, (16, 8))),
    }[kind]
    params = jax.device_get(jax_net.init(jax.random.key(seed), obs))
    if kind == "sac":
        # Spread the log-std head so the clip to [-20, 2] acts.
        params["params"]["log_std"]["bias"] = np.linspace(-30, 5, ACT).astype(np.float32)
    port.load_state_dict(weights.from_flax(params))
    return params, port


def _obs(seed=1):
    return np.random.default_rng(seed).normal(size=(N, OBS)).astype(np.float32) * 2


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["discrete", "gaussian", "ddpg", "sac"])
def test_mirror_params_layout(kind):
    params, port = _pair(kind)
    mine = host_actor.mirror_params(port)
    want, got = _flat(params), _flat(mine)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].flags.c_contiguous, k
        _equal(got[k], v)
    assert host_actor.supports_mirror(mine) == jmirror.supports_mirror(params) is True


def test_snapshot_copies_in_place():
    params, port = _pair("gaussian")
    snap = host_actor.MirrorSnapshot(port)
    snap.enqueue()
    tree = snap.params()
    kernel = tree["params"]["pi_torso"]["dense_0"]["kernel"]
    with torch.no_grad():
        port.pi_torso.dense_0.weight.add_(1.0)
    _equal(kernel, params["params"]["pi_torso"]["dense_0"]["kernel"])  # a copy, not a view
    snap.enqueue()
    assert snap.params() is tree
    _equal(kernel, params["params"]["pi_torso"]["dense_0"]["kernel"] + np.float32(1.0))


@pytest.mark.parametrize("kind", ["discrete", "gaussian"])
def test_ppo_mirrors_equal_jax(kind):
    params, port = _pair(kind)
    mine = host_actor.mirror_params(port)
    discrete = kind == "discrete"
    jspec = JaxEnvSpec(obs_shape=(OBS,), action_dim=ACT, discrete=discrete)
    spec = EnvSpec(obs_shape=(OBS,), action_dim=ACT, discrete=discrete)
    obs = _obs()
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        for a, b in zip(jmirror.make_ppo_host_policy(jspec, None)(params, obs, jr),
                        host_actor.make_ppo_host_policy(spec, None)(mine, obs, tr)):
            _equal(a, b)
    _equal(jmirror.make_ppo_host_value(jspec, None)(params, obs),
           host_actor.make_ppo_host_value(spec, None)(mine, obs))
    _equal(jmirror.make_ppo_host_greedy(jspec, None)(params, obs),
           host_actor.greedy_mirror_for(spec, None, "ppo")(mine, obs))


@pytest.mark.parametrize("kind", ["ddpg", "sac"])
@pytest.mark.parametrize("env_steps", [0, 16], ids=["warmup", "actor"])
def test_offpolicy_mirrors_equal_jax(kind, env_steps):
    params, port = _pair(kind)
    mine = host_actor.mirror_params(port)
    jspec = JaxEnvSpec(obs_shape=(OBS,), action_dim=ACT, discrete=False)
    spec = EnvSpec(obs_shape=(OBS,), action_dim=ACT, discrete=False)
    cfg = Cfg()
    obs = _obs(2)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    explore = {"ddpg": (jmirror.make_ddpg_host_explore, host_actor.make_ddpg_host_explore),
               "sac": (jmirror.make_sac_host_explore, host_actor.make_sac_host_explore)}[kind]
    for _ in range(3):
        _equal(explore[0](jspec, cfg)(params, obs, jr, env_steps),
               explore[1](spec, cfg)(mine, obs, tr, env_steps))
    for algo in ({"ddpg": ("ddpg", "td3"), "sac": ("sac",)}[kind]):
        _equal(jmirror.greedy_mirror_for(jspec, cfg, algo)(params, obs),
               host_actor.greedy_mirror_for(spec, cfg, algo)(mine, obs))


def test_greedy_mirror_for_refuses_unknown_algo():
    with pytest.raises(ValueError, match="no greedy host mirror"):
        host_actor.greedy_mirror_for(None, None, "impala")


def test_conv_torso_keeps_the_device_path():
    assert not host_actor.supports_mirror({"params": {"torso": {"conv_0": {}, "Dense_0": {}}}})
    assert not host_actor.supports_mirror({"params": {"policy": {}}})
