"""Multi-process training (counterpart of `actor_critic_tpu/parallel/`).

- `mesh.py`: process groups (`multihost_init`) and the collective helpers
  the trainers take a `group` for (`pmean`, `psum`, `pmean_tree`, the flat
  gradient all-reduce `FlatGradients`), each the identity without a group.
- `multihost.py`: the multi-process actor-learner, sync (an all-reduce
  learner over NCCL, gloo on the CPU) or gossip (peer-to-peer parameter
  mixing through a filesystem mailbox), and the mailbox transport the
  serving fleet's policy syncer reads.
- `launch.py`: a local N-process launcher (`python -m
  actor_critic_tpu_torch.parallel.launch`).

`dp.py`, `MeshConfig`/`make_mesh` and `seqpar.py` (the fused trainers'
data and sequence parallelism) wait for a later slice. This package
imports `multihost` lazily: the algorithms import `mesh`, and `multihost`
imports the algorithms.
"""

from actor_critic_tpu_torch.parallel.mesh import (
    FlatGradients,
    multihost_init,
    pmean,
    pmean_tree,
    psum,
    world_group,
    world_size,
)

__all__ = [
    "FlatGradients",
    "multihost_init",
    "pmean",
    "pmean_tree",
    "psum",
    "world_group",
    "world_size",
]
