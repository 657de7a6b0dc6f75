"""The off-policy trainers' replay ring on the device (`buffer.py`) and its
storage codecs (`quantize.py`); counterpart of `actor_critic_tpu/replay/`."""

from actor_critic_tpu_torch.replay import quantize
from actor_critic_tpu_torch.replay.buffer import (
    ReplayState,
    add_batch,
    capacity_of,
    draw_indices,
    init,
    sample,
    sample_at,
    sample_sequences,
    sequences_at,
)
from actor_critic_tpu_torch.replay.quantize import QuantStats, offpolicy_codecs

__all__ = [
    "QuantStats",
    "ReplayState",
    "add_batch",
    "capacity_of",
    "draw_indices",
    "init",
    "offpolicy_codecs",
    "quantize",
    "sample",
    "sample_at",
    "sample_sequences",
    "sequences_at",
]
