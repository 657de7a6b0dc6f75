"""The device data plane (counterpart of `actor_critic_tpu/data_plane/`):
trajectory data lives on the card from the actor's enqueue to the
learner's update, so the learner's consume path copies no block to the
card.

- `data_plane.ring`: the device trajectory ring (`DeviceTrajRing`): actors
  enqueue host-encoded blocks on per-slot streams, the learner gathers and
  decodes inside its update (one CUDA graph on the card).
- `data_plane.device_replay`: the off-policy twin (the staged block into
  the replay ring inside one update), and the R2D2-style sequence
  consumer over `replay.sample_sequences`.
- `data_plane.codecs`: the numpy mirror of the `replay/quantize.py`
  codecs (actors encode without touching the card) and the per-key
  trajectory codec specs.

Wiring: `train.py --data-plane {host,device}` with `--async-actors`.
"""

from actor_critic_tpu_torch.data_plane import device_replay  # noqa: F401
from actor_critic_tpu_torch.data_plane.codecs import TRAJ_MODES, traj_codecs  # noqa: F401
from actor_critic_tpu_torch.data_plane.ring import (  # noqa: F401
    DeviceTrajRing,
    RingLease,
    RingState,
    gather_block,
    init_ring,
)
