"""Run one cell of the port's benchmark once:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of stdout is the result (JSON);
the last lines of stderr name each number the check compared beside its
limit. Exits 2 without the CUDA devices the cell asks for and 3 if the
run loaded JAX or the JAX package, printing no result either way.
"""

from __future__ import annotations

import time

_MODULE_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """The process's start on the wall clock, from /proc (10 ms ticks);
    the module's first line where /proc cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return min(time.time() - (uptime - started), _MODULE_START)
    except (OSError, ValueError, IndexError):
        return _MODULE_START


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0 or args.seed >= 2 ** 63 or args.seconds <= 0:
        parser.error("--seed must be in [0, 2**63) and --seconds above 0")
    sys.path.insert(0, str(ROOT))
    from chipbench import core

    return core.main(args, ROOT, process_start())


if __name__ == "__main__":
    sys.exit(main())
