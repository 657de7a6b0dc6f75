"""The warm-up registry's lint, standalone (the counterpart of the JAX
package's `scripts/check_warmup_registry.py`): a thin shim over the
`warmup-registry` pass of the port's static analyzer,
`actor_critic_tpu_torch/analysis/warmup.py`, which holds the scan and the
rule. Same functions, output and exit codes as before the pass existed.

Every CUDA-graph capture site in the port's `algos/`, `envs/`,
`data_plane/` and `serving/` must belong to registered warm-up entries
(`utils/compile_cache.SITES`) or be in `compile_cache.EXEMPT` with a reason.

    python -m actor_critic_tpu_torch.utils.warmup_lint   # exit 1, naming each finding
"""

from __future__ import annotations

import sys

from actor_critic_tpu_torch.analysis.warmup import (  # noqa: F401
    CAPTURE_CALLS,
    PACKAGE,
    SCAN_DIRS,
    capture_sites,
    collect_sites,
    findings,
    main,
)

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
