"""Numpy actor mirrors for the host env path (counterpart of
`actor_critic_tpu/models/host_actor.py`).

A host trainer steps its pool in numpy. With a mirror, it also acts in
numpy (the policies are small MLPs: a few matmuls on the host cost less
than a device round trip per env step), with parameters one update stale,
so the device runs the update of block N while the host collects block
N+1. PPO's clipped ratio and the off-policy replay make the staleness
sound.

The mirrors are the JAX package's, line for line, over the same parameter
tree: `{"params": {<module path>: {"kernel": [in, out], "bias": [out]},
"log_std": ...}}`. `MirrorSnapshot` copies a port module's parameters into
that tree: `kernel` is the transpose of `nn.Linear.weight`, stored
C-contiguous [in, out] float32, as flax stores it. A matmul against a
transposed [out, in] view may block differently in BLAS, and then the
mirror's actions would not be the JAX package's to the bit.

Mirrors cover the MLP-torso nets; pixel (conv) torsos keep the device
acting path (`supports_mirror` is False).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

_LOG_2PI = math.log(2.0 * math.pi)
# As models/distributions.py's TanhGaussian.create clips.
_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


class MirrorSnapshot:
    """Host copies of `module`'s parameters in the mirror's layout.

    `enqueue()` copies every parameter into its host buffer, in stream
    order on the parameters' device (with `pin`, into pinned memory, and
    asynchronously: the copies run when the stream reaches them, and an
    event is recorded after them); `params()` waits for that event and
    returns the tree, whose arrays are views of the buffers (the next
    `enqueue()` overwrites them)."""

    def __init__(self, module: nn.Module, pin: bool = False):
        self._pairs: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._event: Optional[torch.cuda.Event] = None
        self._pin = pin
        self.tree: dict[str, Any] = {}
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            src = p.detach()
            if leaf == "weight":
                leaf, src = "kernel", src.t()
            buf = torch.empty(tuple(src.shape), dtype=torch.float32, pin_memory=pin)
            node = self.tree.setdefault("params", {})
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = buf.numpy()
            self._pairs.append((buf, src))

    def enqueue(self) -> None:
        for buf, src in self._pairs:
            buf.copy_(src, non_blocking=self._pin)
        device = self._pairs[0][1].device
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def params(self) -> dict[str, Any]:
        if self._event is not None:
            self._event.synchronize()
        return self.tree


def mirror_params(module: nn.Module) -> dict[str, Any]:
    """`module`'s parameters as the mirror's tree, copied now (waits for
    the device)."""
    snap = MirrorSnapshot(module)
    snap.enqueue()
    return snap.params()


def _dense(p: dict, x: np.ndarray) -> np.ndarray:
    return x @ np.asarray(p["kernel"]) + np.asarray(p["bias"])


def _mlp(torso: dict, x: np.ndarray, activation) -> np.ndarray:
    for i in range(len(torso)):
        x = activation(_dense(torso[f"dense_{i}"], x))
    return x


def _tanh(x):
    return np.tanh(x)


def _relu(x):
    return np.maximum(x, 0.0)


def _log_softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


def supports_mirror(params: Any) -> bool:
    """True if the parameter tree is an MLP-torso net a mirror covers
    (conv torsos, for pixel obs, keep the device acting path)."""
    p = params.get("params", params)
    torsos = [v for k, v in p.items() if k.endswith("torso")]
    return bool(torsos) and all(all(k.startswith("dense_") for k in t) for t in torsos)


# -- PPO (models/networks.py ActorCriticDiscrete / ActorCriticGaussian) --


def make_ppo_host_policy(env_spec, cfg):
    """(np_params, obs, rng) → (action, log_prob, value), the on-policy
    sampling of `ppo.make_policy_step` in numpy."""
    if env_spec.discrete:

        def policy(params, obs, rng: np.random.Generator):
            p = params["params"]
            z = _mlp(p["torso"], np.asarray(obs, np.float32), _tanh)
            logits = _dense(p["policy"], z)
            value = _dense(p["value"], z)[..., 0]
            # Gumbel-max sampling: a categorical draw.
            g = rng.gumbel(size=logits.shape).astype(np.float32)
            action = np.argmax(logits + g, axis=-1)
            logp = np.take_along_axis(_log_softmax(logits), action[..., None], axis=-1)[..., 0]
            return action, logp.astype(np.float32), value.astype(np.float32)

        return policy

    def policy(params, obs, rng: np.random.Generator):
        p = params["params"]
        obs = np.asarray(obs, np.float32)
        za = _mlp(p["pi_torso"], obs, _tanh)
        zc = _mlp(p["vf_torso"], obs, _tanh)
        mean = _dense(p["policy"], za)
        value = _dense(p["value"], zc)[..., 0]
        log_std = np.broadcast_to(np.asarray(p["log_std"]), mean.shape)
        std = np.exp(log_std)
        action = mean + std * rng.standard_normal(mean.shape).astype(np.float32)
        zscore = (action - mean) / std
        logp = np.sum(-0.5 * (zscore * zscore + _LOG_2PI) - log_std, axis=-1)
        return action.astype(np.float32), logp.astype(np.float32), value.astype(np.float32)

    return policy


def make_ppo_host_value(env_spec, cfg):
    """(np_params, obs) → value: the critic head alone, for the truncation
    bootstrap at `final_obs` and the rollout bootstrap from the SAME stale
    parameters that gave the recorded per-step values (so every baseline
    of one GAE comes from one parameter version)."""
    if env_spec.discrete:

        def value_fn(params, obs):
            p = params["params"]
            z = _mlp(p["torso"], np.asarray(obs, np.float32), _tanh)
            return _dense(p["value"], z)[..., 0].astype(np.float32)

        return value_fn

    def value_fn(params, obs):
        p = params["params"]
        zc = _mlp(p["vf_torso"], np.asarray(obs, np.float32), _tanh)
        return _dense(p["value"], zc)[..., 0].astype(np.float32)

    return value_fn


def make_ppo_host_greedy(env_spec, cfg):
    """(np_params, obs) → the mode action (`ppo.make_greedy_act` in numpy)."""
    if env_spec.discrete:

        def act(params, obs):
            p = params["params"]
            z = _mlp(p["torso"], np.asarray(obs, np.float32), _tanh)
            return np.argmax(_dense(p["policy"], z), axis=-1)

        return act

    def act(params, obs):
        p = params["params"]
        za = _mlp(p["pi_torso"], np.asarray(obs, np.float32), _tanh)
        return _dense(p["policy"], za).astype(np.float32)

    return act


# -- DDPG/TD3 (models/networks.py DeterministicActor) --------------------


def _ddpg_actor_fwd(p: dict, obs) -> np.ndarray:
    """The deterministic tanh actor: the one copy the explore and greedy
    mirrors share."""
    z = _mlp(p["torso"], np.asarray(obs, np.float32), _relu)
    return _tanh(_dense(p["action"], z))


def make_ddpg_host_explore(env_spec, cfg):
    """(np_params, obs, rng, env_steps) → action: the tanh actor plus
    clipped Gaussian noise, uniform in [-1, 1) during the warm-up."""

    def act(params, obs, rng: np.random.Generator, env_steps: int):
        shape = (np.asarray(obs).shape[0], env_spec.action_dim)
        if env_steps < cfg.warmup_steps:
            return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        a = _ddpg_actor_fwd(params["params"], obs)
        a = a + cfg.exploration_noise * rng.standard_normal(shape).astype(np.float32)
        return np.clip(a, -1.0, 1.0).astype(np.float32)

    return act


def make_ddpg_host_greedy(env_spec, cfg):
    """(np_params, obs) → the noiseless actor's action."""

    def act(params, obs):
        return _ddpg_actor_fwd(params["params"], obs).astype(np.float32)

    return act


# -- SAC (models/networks.py SquashedGaussianActor) ----------------------


def _sac_mean_logstd(p: dict, obs) -> tuple[np.ndarray, np.ndarray]:
    """The squashed-Gaussian actor's heads, shared by explore and greedy."""
    z = _mlp(p["torso"], np.asarray(obs, np.float32), _relu)
    mean = _dense(p["mean"], z)
    log_std = np.clip(_dense(p["log_std"], z), _LOG_STD_MIN, _LOG_STD_MAX)
    return mean, log_std


def make_sac_host_explore(env_spec, cfg):
    """(np_params, obs, rng, env_steps) → action: a tanh-Gaussian sample,
    uniform in [-1, 1) during the warm-up."""

    def act(params, obs, rng: np.random.Generator, env_steps: int):
        shape = (np.asarray(obs).shape[0], env_spec.action_dim)
        if env_steps < cfg.warmup_steps:
            return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        mean, log_std = _sac_mean_logstd(params["params"], obs)
        pre = mean + np.exp(log_std) * rng.standard_normal(shape).astype(np.float32)
        return _tanh(pre).astype(np.float32)

    return act


def make_sac_host_greedy(env_spec, cfg):
    """(np_params, obs) → tanh(mean)."""

    def act(params, obs):
        mean, _ = _sac_mean_logstd(params["params"], obs)
        return _tanh(mean).astype(np.float32)

    return act


_GREEDY_MIRRORS = {
    "ppo": make_ppo_host_greedy,
    "ddpg": make_ddpg_host_greedy,
    "td3": make_ddpg_host_greedy,
    "sac": make_sac_host_greedy,
}


def greedy_mirror_for(env_spec, cfg, algo: str):
    """The greedy mirror `(np_params, obs) -> action` of `algo`, or
    ValueError where none exists. Callers still check `supports_mirror`."""
    try:
        maker = _GREEDY_MIRRORS[algo]
    except KeyError:
        raise ValueError(
            f"no greedy host mirror for algo {algo!r}; mirrored: {sorted(_GREEDY_MIRRORS)}"
        ) from None
    return maker(env_spec, cfg)
