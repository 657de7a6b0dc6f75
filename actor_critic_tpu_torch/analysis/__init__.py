"""Runtime sanitizers of the port (counterpart of `actor_critic_tpu/analysis/`),
each a module with its exercisers and a CLI (`python -m
actor_critic_tpu_torch.analysis.<name>`):

- `racesan`: seeded cooperative schedules over the async actor–learner and
  serving objects, with write-after-publish poisoners;
- `numsan`: seeded NaN/Inf/saturation poisons against the commit gates, the
  divergence monitor and the codecs;
- `padsan`: seeded pad-lane poisons against the scan kernels' ragged edges,
  the mixture's parked members, the serving buckets and the device ring;
- `fleetsan`: seeded process-level chaos (kills, torn files, stale and
  duplicate snapshots) over the parameter mailbox, the gossip ring and the
  serving swap path, and a real-process SIGKILL of a gossip worker;
- `perfsan`: dispatches, host↔device transfers and recompiles a
  steady-state block of the port's programs, against the budgets of
  `perf_budgets.json` beside it.

JAX's jaxlint passes (`baseline`, `core` and the AST models) are JAX-specific
and have no counterpart. Modules are imported on use, not here.
"""

__all__ = ["fleetsan", "numsan", "padsan", "perfsan", "racesan"]
