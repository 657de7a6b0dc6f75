"""The port's analysis layer (counterpart of `actor_critic_tpu/analysis/`):
a static analyzer over the port's own source, and runtime sanitizers.

**torchlint**, the static analyzer (`python -m
actor_critic_tpu_torch.analysis.torchlint`, the JAX package's
`scripts/jaxlint.py`): pure `ast` over source text, importing nothing it
scans, no JAX and nothing of `actor_critic_tpu`. Its passes keep JAX's
check names, re-grounded on the port's CUDA-graph captures, threads, ranks
and hot loops:

    tracer-leak           a host sync (if/while/assert/bool()/.item()) on a
                          tensor inside a CUDA-graph capture
    prng-reuse            a generator drawn inside a capture without being
                          registered with the graph; generators seeded alike
    recompile-hazard      a capture inside a loop; shape-/len()-derived
                          values fed to a captured program
    donation-aliasing     restored tensors rebound into a captured state;
                          graph outputs read after the next replay
    warmup-registry       capture sites without registered warm-up entries
                          (`utils/warmup_lint.py` is its standalone shim)
    lock-discipline       compound writes to cross-thread shared state
                          outside a lock (thread_model.py)
    publish-aliasing      array/tensor views of recycled slots crossing
                          thread channels, or aliased past their release
    check-then-act        unlocked read-test-write windows on shared flags
    collective-discipline undeclared mesh axes; collectives gated on
                          process-local values or inside swallowing `try`s
                          (process_model.py)
    mailbox-protocol      the gossip mailbox's write→fsync→rename, torn-read
                          tolerance, per-peer clocks
    rank-affinity         shared artifact paths without the rank in
                          per-rank scopes
    transfer-discipline   host↔device crossings in steady-state loops
                          (alias host-sync; perf_model.py)
    donation-discipline   recycled buffers rebuilt out of place where the
                          port writes in place
    dispatch-granularity  Python reductions, eager torch math and
                          multi-program chains in per-step loops

Pragmas: `# torchlint: disable=<check>` (the why in the same comment),
`# torchlint: thread-owned=<role>`, `# torchlint: hot-module`. Accepted
findings live in `torchlint_baseline.json` beside this file, each with its
reason. Tier-1 gates the port's tree on it (`tests/test_torch_lint.py`).

**Runtime sanitizers**, each a module with its exercisers and a CLI
(`python -m actor_critic_tpu_torch.analysis.<name>`), imported on use:

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

The numerics passes (precision-discipline, nonfinite-hazard, sink-guard)
and the shape passes (pad-mask-discipline, mask-propagation,
slice-before-commit) are not ported yet.
"""

from actor_critic_tpu_torch.analysis.baseline import (
    apply_baseline,
    default_baseline_path,
    load_baseline,
    regenerate,
    save_baseline,
)
from actor_critic_tpu_torch.analysis.core import (
    AnalysisError,
    Check,
    Finding,
    ModuleInfo,
    analyze_paths,
    load_modules,
    register_check,
    registered_checks,
    run_checks,
)

__all__ = [
    "AnalysisError",
    "Check",
    "Finding",
    "ModuleInfo",
    "analyze_paths",
    "apply_baseline",
    "default_baseline_path",
    "load_baseline",
    "load_modules",
    "regenerate",
    "register_check",
    "registered_checks",
    "run_checks",
    "save_baseline",
]
