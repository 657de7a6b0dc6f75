"""One run of one cell of the port's benchmark.

Set-up (`setup_s`, from the process's start to the first timed replay):
the cell's env and config from the port's preset with the configuration
file's values and the traffic's E and T, the trainer's state, the
benchmark's own weights written into it, the train step, and the loop's
warm-up (`algos/loop.py::warm_up`: two eager iterations put back bitwise,
then the capture of one step as a CUDA graph). Only this cell's shapes
are warmed. The check's first steps (`check_iterations`) then run
through the window's own call, the graph's replay, and their readings are
kept.

The timed window replays the graph back to back until `--seconds` have
passed on the host's clock, reads the metrics on the host every
`LOG_EVERY` iterations, as the training CLI logs them, records a CUDA
event before each replay and one after the last, and reads the events
only after a final synchronise: a closed loop, each step following the
last. With `--trace 1` two blocks of `TRACE_ITERATIONS` replays run in
place of the window, the second under torch.profiler, and one rollout
and one update are captured as graphs of their own and timed by CUDA
events.

After the window the peak memory is read, the program is freed, and the
plain reference follows the same steps (`check.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from chipbench import catalog, check

# Top-level module names that must not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name starts with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "actor_critic_tpu")
# The host reads the metrics every LOG_EVERY iterations, as the training
# CLI's default `--log-every 10`.
LOG_EVERY = 10
# Replays in each of a traced run's two blocks (untraced, profiled), and
# the rollout and update graphs' timed repeats.
TRACE_ITERATIONS = 12
SPLIT_REPEATS = 10
# The weights' generator is seeded apart from the program's, whose seed is
# the run's.
WEIGHT_SEED_XOR = 0x5DEECE66D


def check_iterations(conf: dict) -> int:
    """Train steps the check follows: three, and one past the first actor
    refresh where the configuration keeps stale actors, so that the
    refreshed actors and the rollout they drive are compared."""
    return max(3, conf["config"].get("actor_refresh_every", 0) + 1)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def make_weights(cell: catalog.Cell, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter of the cell's network from the seed, in one draw on
    the device: N(0, gain² / fan_in) for weights, zero for biases."""
    leaves = cell.config_mod.leaves(cell.conf)
    g = torch.Generator(device=device).manual_seed(seed ^ WEIGHT_SEED_XOR)
    total = sum(math.prod(shape) for _, shape, gain in leaves if gain > 0)
    noise = torch.randn(total, generator=g, device=device)
    out, offset = {}, 0
    for name, shape, gain in leaves:
        if gain > 0:
            n = math.prod(shape)
            out[name] = noise[offset:offset + n].view(shape) * (gain / math.sqrt(math.prod(shape[1:])))
            offset += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


class Program:
    """The port's trainer for a cell, built as the training CLI builds it,
    holding the benchmark's weights; `replay()` runs one train step through
    its captured graph on the card (eagerly on the CPU)."""

    def __init__(self, cell: catalog.Cell, seed: int, device, bf16: bool = False):
        t_import = time.perf_counter()
        from actor_critic_tpu_torch import train
        from actor_critic_tpu_torch.algos import loop
        from actor_critic_tpu_torch.config import PRESETS

        conf = cell.conf
        fields = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["config"].items()}
        fields["bf16_compute"] = bf16 or fields.get("bf16_compute", False)
        self.mod = train.ALGOS[conf["algo"]]
        self.cfg = dataclasses.replace(PRESETS[conf["preset"]].config, **fields,
                                       num_envs=cell.num_envs, rollout_steps=cell.steps)
        self.env = train.make_env(conf["env"], conf["env_kwargs"])
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.state = self.mod.init_state(self.env, self.cfg, seed, self.device)
        self.weights = make_weights(cell, seed, self.device)
        self._load_weights()
        self.step = self.mod.make_train_step(self.env, self.cfg)
        t1 = time.perf_counter()
        graphs = (1,) if self.device.type == "cuda" else ()
        self.captured = loop.warm_up(self.step, self.state, graphs).get(1)
        # Set-up's parts on the host's clock, for the record.
        self.setup_parts = {"program_import_s": t0 - t_import, "state_s": t1 - t0,
                            "warm_up_and_capture_s": time.perf_counter() - t1}

    def _load_weights(self) -> None:
        """The benchmark's weights into every network the state holds (the
        learner, and IMPALA's actors, which start in sync)."""
        for f in dataclasses.fields(self.state):
            net = getattr(self.state, f.name)
            if not isinstance(net, torch.nn.Module):
                continue
            params = dict(net.named_parameters())
            if set(params) != set(self.weights):
                raise ValueError(f"the network's leaves {sorted(params)} are not the "
                                 f"configuration's {sorted(self.weights)}")
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(self.weights[k])

    def replay(self) -> dict[str, torch.Tensor]:
        if self.captured is not None:
            return self.captured.replay()
        return self.step(self.state)[1]

    def first_steps(self, cell: catalog.Cell) -> dict:
        """The check's readings of the first `check_iterations` steps."""
        losses, grads = [], None
        for i in range(check_iterations(cell.conf)):
            losses.append(float(self.replay()["loss"]))
            if i == 0:
                grads = cell.config_mod.first_grad_norms(cell.conf, self.state.opt_state)
        out = {"losses": losses, "grad_norms": grads, "delta_norms": self._change(self.state.net),
               "state": cell.config_mod.program_state(self.state)}
        actors = getattr(self.state, "actor_net", None)
        if actors is not None:
            out["actor_delta_norms"] = self._change(actors)
        return out

    def _change(self, net: torch.nn.Module) -> dict[str, float]:
        """Each parameter's change from the benchmark's weights (L2, float64)."""
        return {k: math.sqrt(float(((p.detach() - self.weights[k]).double() ** 2).sum()))
                for k, p in net.named_parameters()}


class Marks:
    """Points on the device's timeline: CUDA events on the card, the host's
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        """Each mark's time after the first; waits for the device."""
        if self.cuda:
            torch.cuda.synchronize()
            return [self.marks[0].elapsed_time(e) / 1e3 for e in self.marks]
        return [t - self.marks[0] for t in self.marks]


@dataclasses.dataclass
class Block:
    """A run of replays: its marks (one before each replay and one after
    the last, in seconds), the host's time in each `replay()` call, and
    the metric rows read."""

    marks_s: list[float]
    host_replay_s: list[float]
    failed: int

    @property
    def iterations(self) -> int:
        return len(self.marks_s) - 1

    @property
    def seconds(self) -> float:
        return self.marks_s[-1] - self.marks_s[0]


def replay_block(program: Program, seconds: float = 0.0, iterations: int = 0,
                 ranges: bool = False, on_first=None) -> Block:
    """Replay back to back until `seconds` have passed (host clock) or for
    `iterations` replays, reading the metrics on the host every
    `LOG_EVERY`; `ranges` names the host's phases for the profiler."""
    from torch.profiler import record_function

    def phase(name):
        return record_function(name) if ranges else contextlib.nullcontext()

    marks = Marks(program.device)
    host, failed, n = [], 0, 0
    deadline = time.perf_counter() + seconds
    while True:
        if n == 0 and on_first is not None:
            on_first()
        marks.mark()
        with phase("chipbench.replay"):
            t0 = time.perf_counter()
            metrics = program.replay()
            host.append(time.perf_counter() - t0)
        n += 1
        if n % LOG_EVERY == 0:
            with phase("chipbench.read_metrics"):
                row = {k: float(v) for k, v in metrics.items()}
            failed += not math.isfinite(row["loss"])
        if (iterations and n >= iterations) or (not iterations and time.perf_counter() >= deadline):
            break
    marks.mark()
    with phase("chipbench.synchronize"):
        marks_s = marks.seconds()
    return Block(marks_s=marks_s, host_replay_s=host, failed=failed)


def profile_block(program: Program, iterations: int) -> dict:
    """A block of replays under torch.profiler: every device operation's
    (name, start µs, end µs), the host's named phases, and the traced
    window (µs), from the block's first phase to the end of its final
    synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        block = replay_block(program, iterations=iterations, ranges=True)
    device_ops, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith("chipbench."):
            # The host's phases; the profiler also mirrors each on the
            # device's timeline, which is no device operation.
            if e.device_type != DeviceType.CUDA:
                host.append(span)
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device_ops.append(span)
    if not host:
        raise RuntimeError("the profiler recorded none of the harness's host phases")
    start = min(s for _, s, _ in host)
    end = max(t for _, _, t in host)
    ops = [op for op in device_ops if op[1] >= start and op[2] <= end]
    return {"device_ops": ops, "host_phases": host, "window_us": (start, end),
            "iterations": block.iterations, "failed": block.failed}


def time_split(program: Program, repeats: int) -> Optional[dict]:
    """One rollout and one update, each captured as a graph of its own
    from the state as it is, replayed in turns `repeats` times; the mean
    device ms of each from CUDA events. None off the card."""
    if program.device.type != "cuda":
        return None
    from actor_critic_tpu_torch.algos import loop

    mod, env, cfg, state = program.mod, program.env, program.cfg, program.state
    opt = mod.make_optimizer(cfg)
    rollout = torch.cuda.CUDAGraph()
    rollout.register_generator_state(state.generator)
    with loop.capture(rollout):
        traj = mod.rollout(env, cfg, state)
    update = torch.cuda.CUDAGraph()
    with loop.capture(update):
        mod.update(env, cfg, opt, state, traj)
    rollout.replay()  # a graph's first replay uploads it: not timed
    update.replay()
    events = []
    for _ in range(repeats):
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        rollout.replay()
        b.record()
        update.replay()
        c.record()
        events.append((a, b, c))
    torch.cuda.synchronize()
    return {"rollout_ms": statistics.fmean(a.elapsed_time(b) for a, b, _ in events),
            "update_ms": statistics.fmean(b.elapsed_time(c) for _, b, c in events)}


def free(program: Program) -> None:
    """Drop the program's graphs and state and return their memory."""
    program.captured = program.state = program.step = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Run:
    """What a run hands its metric readers."""

    cell: catalog.Cell
    setup_s: float
    window: Optional[Block] = None   # the timed window (--trace 0)
    plain: Optional[Block] = None    # the untraced block (--trace 1)
    trace: Optional[dict] = None     # the profiled block (--trace 1)
    split: Optional[dict] = None     # rollout and update graphs (--trace 1)


def busy_intervals(ops: list) -> list[tuple[float, float]]:
    """The union of the operations' [start, end] intervals, merged."""
    merged: list[list[float]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps named by the harness's host phase at their middle."""
    totals: dict[str, float] = {}
    for name, s, e in trace["device_ops"]:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    start, end = trace["window_us"]
    edges = [start] + [x for iv in busy_intervals(trace["device_ops"]) for x in iv] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [n for n, a, b in trace["host_phases"] if a <= mid <= b]
        named.append((inside[-1] if inside else "host outside the harness's phases", (e - s) / 1e6))
    named.sort(key=lambda x: -x[1])
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in named[:10]]}


def device_info(device: torch.device, peak: int, run: Optional[Run] = None) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    if run is not None and run.trace is not None:
        start, end = run.trace["window_us"]
        busy = sum(e - s for s, e in busy_intervals(run.trace["device_ops"]))
        info["busy_s"] = busy / 1e6
        info["window_s"] = (end - start) / 1e6
    return info


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi not read ({e})"


def execute(cat: catalog.Catalog, workload: str, seed: int, seconds: float, trace: bool,
            process_start: float, device="cuda") -> tuple[dict, list[str]]:
    """One run of `workload`: returns (the result line's object, the lines
    that name each number compared beside its limit). `device="cpu"` is for
    the tests: it runs the same path eagerly, and its times are the host's."""
    cell = cat.cell(workload)
    device = torch.device(device)
    t_program = time.time()
    program = Program(cell, seed, device)
    t_check = time.time()
    readings = program.first_steps(cell)
    parts = {"before_program_s": t_program - process_start, **program.setup_parts,
             "check_steps_s": time.time() - t_check}
    setup = {}
    run = Run(cell=cell, setup_s=0.0)
    if trace:
        run.plain = replay_block(program, iterations=TRACE_ITERATIONS)
        attempted, failed = run.plain.iterations, run.plain.failed
        if device.type == "cuda":
            run.trace = profile_block(program, TRACE_ITERATIONS)
            attempted, failed = attempted + run.trace["iterations"], failed + run.trace["failed"]
        run.split = time_split(program, SPLIT_REPEATS)
    else:
        def first():
            setup["t"] = time.time()

        run.window = replay_block(program, seconds=seconds, on_first=first)
        run.setup_s = setup["t"] - process_start
        attempted, failed = run.window.iterations, run.window.failed
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    weights = program.weights
    free(program)
    reference = cell.reference_mod.run(cell.conf, cell.num_envs, cell.steps, weights, seed, device,
                                       iterations=check_iterations(cell.conf))
    numbers = check.gaps(readings, reference)
    ok, checks = check.judge(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cat.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(device, peak, run)}
    if run.trace is not None:
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    lines = ["set-up parts (host clock): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())]
    lines += [f"uncompared {k} {v!r}" for k, v in numbers.items() if k not in checks]
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(args, root: Path, process_start: float) -> int:
    """The CLI's run: refuse without enough cards, run, refuse if JAX or
    the JAX package was loaded, print the check's lines on stderr and the
    result as the last line of stdout."""
    t_main = time.time()
    cat = catalog.Catalog(root)
    cell = cat.cell(args.workload)
    available = torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips
    host_parts = f"imports_s {t_main - process_start:.3f}, cuda_probe_s {time.time() - t_main:.3f}"
    if not available:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {count} available",
              file=sys.stderr)
        return 2
    result, lines = execute(cat, args.workload, args.seed, args.seconds, bool(args.trace),
                            process_start)
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"set-up before the program (host clock): {host_parts}", file=sys.stderr, flush=True)
    found = forbidden_loaded()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    if result["metrics"].get("iter_ms_p95") is not None:
        print(f"iter_ms_p95 over {result['attempted']} iteration intervals", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
