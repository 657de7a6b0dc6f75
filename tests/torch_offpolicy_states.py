"""JAX off-policy learners → the port's, for the parity tests
(`test_torch_ddpg.py`, `test_torch_sac.py`).

A JAX `LearnerState` / `SACLearnerState` holds flax parameter trees, optax
Adam states, a replay ring of int32 cursors and a PRNG key; the port's
holds modules, `AdamState`s and an int64-cursored ring. `load_learner`
copies a JAX learner into a port learner built for the same config, in
place; `learner_tensors` names every tensor of a port learner (the
checkpoint's names), so that two learners compare leaf by leaf; `draws`
reproduces the random draws of JAX's `one_update` from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos.common import named_carried
from actor_critic_tpu_torch.tree import tree_leaves


def _copy(dst: torch.Tensor, value) -> None:
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(value)).to(dst.dtype).reshape(dst.shape))


def _load_module(module, params) -> None:
    module.load_state_dict(weights.from_flax(jax.device_get(params)))


def _load_adam(dst, opt_state, names=None) -> None:
    """An optax `adam` state into the port's `AdamState` `dst`: through
    `weights.adam_state_from_optax` for a parameter tree, by hand for SAC's
    scalar log α (`names` its one key)."""
    opt_state = jax.device_get(opt_state)
    if names is None:
        src = weights.adam_state_from_optax(opt_state)
        count, mu, nu = src.count, src.mu, src.nu
    else:
        node = opt_state[0]  # optax.adam: (ScaleByAdamState, EmptyState)
        count, mu, nu = node.count, {names: node.mu}, {names: node.nu}
    _copy(dst.count, count)
    for moment, values in (("mu", mu), ("nu", nu)):
        for k, t in getattr(dst, moment).items():
            _copy(t, values[k])


def load_learner(port, jls) -> None:
    """Copy the JAX learner `jls` into the port learner `port` in place."""
    _load_module(port.actor, jls.actor_params)
    _load_module(port.critic, jls.critic_params)
    _load_module(port.target_critic, jls.target_critic)
    _load_adam(port.actor_opt, jls.actor_opt)
    _load_adam(port.critic_opt, jls.critic_opt)
    if hasattr(jls, "target_actor"):
        _load_module(port.target_actor, jls.target_actor)
    if hasattr(jls, "log_alpha"):
        _copy(port.log_alpha, jls.log_alpha)
        _load_adam(port.alpha_opt, jls.alpha_opt, names="log_alpha")
    ring = jls.replay
    for dst, src in zip(tree_leaves(port.replay.storage), jax.tree.leaves(ring.storage), strict=True):
        _copy(dst, src)
    for dst, src in zip(tree_leaves(port.replay.quant), jax.tree.leaves(ring.quant), strict=True):
        _copy(dst, src)
    _copy(port.replay.insert_pos, ring.insert_pos)
    _copy(port.replay.size, ring.size)
    _copy(port.update_count, jls.update_count)


def learner_tensors(port) -> dict[str, torch.Tensor]:
    return {k: t.detach().clone() for k, t in named_carried(port, "learner").items()}


def max_differences(got: dict, want: dict) -> dict[str, float]:
    assert sorted(got) == sorted(want)
    return {k: float((got[k].double() - want[k].double()).abs().max()) for k in got}


def ddpg_draws(jls, cfg, action_dim):
    """(slots or window starts [B], target noise [B, A] or None) of JAX's
    DDPG/TD3 `one_update` from `jls.key`."""
    _, skey, tkey = jax.random.split(jls.key, 3)
    size = jls.replay.size
    bound = jnp.maximum(size - cfg.nstep + 1, 1) if cfg.nstep > 1 else jnp.maximum(size, 1)
    idx = jax.random.randint(skey, (cfg.batch_size,), 0, bound, dtype=jnp.int32)
    eps = None
    if cfg.target_noise > 0.0:
        eps = torch.from_numpy(np.array(jax.random.normal(tkey, (cfg.batch_size, action_dim))))
    return torch.from_numpy(np.array(idx).astype(np.int64)), eps


def sac_draws(jls, cfg, action_dim):
    """(slots [B], target-sample ε [B, A], actor-sample ε [B, A]) of JAX's
    SAC `one_update` from `jls.key`."""
    _, skey, tkey, akey = jax.random.split(jls.key, 4)
    idx = jax.random.randint(skey, (cfg.batch_size,), 0, jnp.maximum(jls.replay.size, 1),
                             dtype=jnp.int32)
    normal = lambda k: torch.from_numpy(np.array(
        jax.random.normal(k, (cfg.batch_size, action_dim), jnp.float32)))
    return torch.from_numpy(np.array(idx).astype(np.int64)), normal(tkey), normal(akey)
