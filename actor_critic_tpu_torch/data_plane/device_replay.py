"""The device replay plane of the off-policy trainers (counterpart of
`actor_critic_tpu/data_plane/device_replay.py`).

The async off-policy learner (`host_loop.off_policy_train_host_async`)
with the host data plane copies each consumed transition block to the
card on the learner's thread. With the device plane, actors stage encoded
blocks in a `data_plane.ring.DeviceTrajRing`, and ONE update per consumed
block gathers and decodes the staged slot, writes it into the replay ring,
gates, and runs the update loop: on the card one CUDA graph
(`host_loop.HostUpdate`), with the slot index and the env-step count as
its only inputs, both written by fill kernels.

Also here: the R2D2-style sequence consumer over
`replay.sample_sequences` (arxiv 1803.0933's burn-in / train split):
`sample_training_sequences` draws [B, burn_in + L] windows of consecutive
inserts, splits the burn-in prefix from the train window, and returns the
episode-validity mask consumers weight losses with
(`sequence_window_mask`, the alive-before-done convention of
`ddpg.nstep_batch`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from actor_critic_tpu_torch import replay
from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.data_plane import ring as dp_ring
from actor_critic_tpu_torch.tree import tree_map


def offpolicy_block_spec(spec, cfg, actors: int) -> dict:
    """The [K, E_a] transition block an off-policy `ActorService` pushes
    (the `host_collect` keys; E_a = num_envs // actors). `last_obs` rides
    along because every block carries it; the ingest ignores it."""
    actors = max(int(actors), 1)
    K = cfg.steps_per_iter
    E = cfg.num_envs // actors
    s = dp_ring.array_spec
    # Host pools emit float32 observations (pixel pools are not ported).
    obs = lambda lead: s((*lead, *spec.obs_shape), "float32")  # noqa: E731
    return {
        "obs": obs((K, E)),
        "action": s((K, E, spec.action_dim), "float32"),
        "reward": s((K, E), "float32"),
        "done": s((K, E), "float32"),
        "terminated": s((K, E), "float32"),
        "final_obs": obs((K, E)),
        "last_obs": obs((E,)),
    }


def make_device_ingest_update(ingest_update, ring_codecs: dict):
    """`(learner, ring_state, slot, env_steps, generator) -> metrics`: gather
    and decode the staged block, then `ingest_update` (an algorithm's
    `make_host_ingest_update`: the block into the replay ring, the gate at
    env_steps ≥ warmup_steps and the algorithm's floor of ring transitions,
    the update loop), the learner written in place. JAX builds the same
    program per algorithm (`ddpg/sac.make_device_ingest_update`) from
    `make_update_loop` and the floor; here the two planes share the host
    plane's ingest, so they run one update body."""

    def device_ingest_update(ls, ring_state: dp_ring.RingState, slot: torch.Tensor,
                             env_steps: torch.Tensor, generator: torch.Generator):
        block = dp_ring.gather_block(ring_state, slot, ring_codecs)
        traj = OffPolicyTransition(obs=block["obs"], action=block["action"],
                                   reward=block["reward"], next_obs=block["final_obs"],
                                   terminated=block["terminated"], done=block["done"])
        return ingest_update(ls, traj, env_steps, generator)

    return device_ingest_update


# ---------------------------------------------------------------------------
# The R2D2-style sequence consumer (replay.sample_sequences)
# ---------------------------------------------------------------------------

def sequence_window_mask(done: torch.Tensor) -> torch.Tensor:
    """[B, L] done flags → float32 validity mask: step t is valid iff no
    episode ended at a step STRICTLY BEFORE t inside the window (the step
    carrying the terminal reward belongs to its episode)."""
    d = done.to(torch.float32)
    return torch.cumprod(torch.cat([torch.ones_like(d[:, :1]), 1.0 - d[:, :-1]], dim=1), dim=1)


def split_burn_in(seq: Any, burn_in: int):
    """[B, burn_in + L] windows → (burn, train, train_mask): `burn` (None
    when burn_in == 0) warms recurrent state with gradients stopped by the
    consumer; `train` carries the loss steps; `train_mask` is the mask over
    the WHOLE window sliced to the train half, so a done inside the burn-in
    invalidates the train steps after it."""
    mask = sequence_window_mask(seq.done)
    train = tree_map(lambda x: x[:, burn_in:], seq)
    if burn_in == 0:
        return None, train, mask
    burn = tree_map(lambda x: x[:, :burn_in], seq)
    return burn, train, mask[:, burn_in:]


def sample_training_sequences(state: replay.ReplayState, generator: torch.Generator,
                              batch_size: int, seq_len: int, burn_in: int = 0,
                              codecs: Optional[Any] = None):
    """`batch_size` R2D2-style windows of `burn_in + seq_len` CONSECUTIVE
    INSERTS (`replay.sample_sequences`' window contract), split into
    (burn, train, train_mask). Callers ensure size >= burn_in + seq_len and
    that consecutive inserts are one env's steps (num_envs == 1)."""
    seq = replay.sample_sequences(state, generator, batch_size, burn_in + seq_len, codecs)
    return split_burn_in(seq, burn_in)


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402


@_compile_cache.register_warmup("device_replay.make_device_ingest_update")
def _warmup_device_ingest(ctx):
    """The off-policy learner's update on the device data plane (the slot
    gathered and decoded into the replay ring, the gate, the update loop),
    captured before the actors start."""
    if (ctx.data_plane != "device" or not ctx.async_actors or ctx.fused
            or ctx.algo not in ("ddpg", "td3", "sac")):
        return None
    return _compile_cache.warmup_of(ctx, host=True)
