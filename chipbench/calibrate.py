"""The readings that the check's limits are set from, for one cell at its
own size, in one process:

    python3 chipbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --fault-seeds 3 [--first-seed S] [--out calibrate_<cell>.jsonl]

For each seed the program's first steps (`core.check_iterations`: three,
or one past the first actor refresh) through its captured graph
(as a run's set-up takes them) against the reference: the sound
readings, whose largest is a number's lower reading. Then, on the first
seeds, the control: the program with its own bf16 compute path switched
on, one precision below the configuration's float32, against the same
reference; and the faults a training cell can have, planted in the
reference put in the program's place ("half_batch": the loss over half
the envs; "altered_reward": one env's rewards altered where they are
produced). A state left unchanged reads 1 on `delta_gap`, and actors
never refreshed read 1 on `actor_gap`: neither needs a run. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("half_batch", "altered_reward")


def readings(cat, workload: str, seed: int, bf16: bool, device) -> tuple[dict, dict, float]:
    """(program readings, its weights, seconds) for one seed."""
    from chipbench import core

    cell = cat.cell(workload)
    t0 = time.perf_counter()
    program = core.Program(cell, seed, device, bf16=bf16)
    out = program.first_steps(cell)
    weights = program.weights
    core.free(program)
    return out, weights, time.perf_counter() - t0


def calibrate(cat, workload: str, seeds: list[int], control_seeds: int, fault_seeds: int,
              device, emit) -> dict:
    """Emit one record per reading and return the summary: for each number
    the largest sound reading and the least of the control's and of each
    fault's."""
    from chipbench import check, core

    cell = cat.cell(workload)
    sound: dict[str, list[float]] = {}
    others: dict[str, dict[str, list[float]]] = {}

    def ref(weights, seed, fault=None):
        t0 = time.perf_counter()
        out = cell.reference_mod.run(cell.conf, cell.num_envs, cell.steps, weights, seed, device,
                                     iterations=core.check_iterations(cell.conf), fault=fault)
        return out, time.perf_counter() - t0

    for i, seed in enumerate(seeds):
        prog, weights, prog_s = readings(cat, workload, seed, False, device)
        reference, ref_s = ref(weights, seed)
        numbers = check.gaps(prog, reference)
        emit({"kind": "sound", "seed": seed, **numbers, "program_s": prog_s, "reference_s": ref_s,
              "losses": prog["losses"], "reference_losses": reference["losses"]})
        for k, v in numbers.items():
            sound.setdefault(k, []).append(v)
        if i < control_seeds:
            control, _, _ = readings(cat, workload, seed, True, device)
            numbers = check.gaps(control, reference)
            emit({"kind": "control_bf16", "seed": seed, **numbers})
            for k, v in numbers.items():
                others.setdefault("control_bf16", {}).setdefault(k, []).append(v)
        if i < fault_seeds:
            for fault in FAULTS:
                faulty, _ = ref(weights, seed, fault)
                numbers = check.gaps(faulty, reference)
                emit({"kind": fault, "seed": seed, **numbers})
                for k, v in numbers.items():
                    others.setdefault(fault, {}).setdefault(k, []).append(v)
    summary = {"lower": {k: max(v) for k, v in sound.items()},
               **{f"least_{kind}": {k: min(v) for k, v in d.items()} for kind, d in others.items()}}
    emit({"kind": "summary", "workload": workload, **summary})
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=2_147_483_700)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from chipbench import catalog

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cat = catalog.Catalog(ROOT)
    out = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps({k: (None if isinstance(v, float) and not math.isfinite(v) else v)
                           for k, v in record.items()})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
        calibrate(cat, args.workload, seeds, args.control_seeds, args.fault_seeds, "cuda", emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
