"""padsan: deterministic padding-lane poison sanitizer (counterpart of
`actor_critic_tpu/analysis/padsan.py`).

numsan checks the stack's response to poisoned VALUES; padsan checks its
*indifference* to poisoned PADDING. Every seam that widens a ragged batch
to a fixed shape claims its junk lanes are never observable. padsan runs
each REAL program twice per seeded schedule, once with the pad lanes
zeroed (the production fill) and once poisoned from the menu

    nan      quiet NaN
    big      +3e38 (near float32's max: overflows any sum it touches)
    -big     -3e38
    int8sat  127.0, and an integer storage's saturation point (±127/-128)

and asserts the valid-lane outputs are BITWISE identical; any difference
is a junk-lane leak and raises `PadSanError` naming the seed, scenario and
poison for replay.

The port's seams (JAX's scenario names):

- **pallas**: the port's scan kernels (`csrc/gae.cu`, `csrc/vtrace.cu`
  on `csrc/scan_tile.cuh`) pad no lanes; their counterpart seam is the
  partial last strip of 16 columns and the last chunk of fewer than 64
  rows, which the kernels copy with guards and zero-fill. At ragged
  E ∈ {7, 96, 200} (E = 7 takes the 4-byte copies, 96 and 200 the 16-byte
  ones) and T = 100 (a 64-row chunk and a 36-row one), every [T, E] input
  is the leading part of a flat allocation whose tail is zero-filled in
  one run and poison-filled in the other, and the outputs go into flat
  allocations pre-filled the same way (`out=` of `ops/gae_cuda.gae` and
  `ops/vtrace_cuda.vtrace`): the [T, E] outputs must be bitwise equal
  between the runs and the output tails must still hold the fill, so any
  read or write past E or past T shows. GAE, the λ-returns (GAE's second
  output) and V-trace, on the card through the kernels.
- **mixture**: the fleet keeps one state slot per member type and
  selects by type (`envs/mixture.py`); the parked slots are poison-filled
  and the live member's transition, its next state and the mask-multiplied
  padded obs must not change.
- **serving**: `PolicyEngine.act` at ragged n pads to its bucket through
  `pad_to_bucket` (`serving/engine.py`); the B-run fills the standby rows
  with the poison, and the first n actions must equal the zero fill's (on
  the card every bucket is a CUDA graph replay).
- **device-plane**: `DeviceTrajRing` + `gather_block`; every slot but the
  leased one is poison-filled and the decode must not change.
- JAX's **chunked** scenario has no counterpart seam: a chunk cut short in
  the port replays one-step graphs (`algos/loop.py`) instead of padding to
  the stride and masking with `n_valid`. The CLI refuses it and says so.

Every schedule also routes a summary of the padded buffer through
`masked_summary` (a where-select masked mean). **Reverted modes** prove
the detectors work: `revert="unmasked-mean"` swaps it for a plain mean,
which reads the junk lanes and must be caught; `revert="no-slice"`
(pallas, serving) compares the FULL allocation or bucket instead of the
valid part, whose junk differs by construction and must be caught.

A clean schedule appends to `report["trace"]`, and `report["digest"]` is a
sha256 over it, the same for every run of a seed. The lane, op and poison
draws are Python's `random.Random`, JAX's draws for a seed.

    python -m actor_critic_tpu_torch.analysis.padsan                  # quick profile
    python -m actor_critic_tpu_torch.analysis.padsan --scenario pallas --revert no-slice

Exit codes: 0 clean, 1 violation (or a reverted guard caught), 2 crash or
usage error. The exercisers run on the card unless `device="cpu"`.
"""

from __future__ import annotations

import hashlib
import random
from typing import Iterable, Optional

import numpy as np
import torch

POISONS = ("nan", "big", "-big", "int8sat")
_VALUES = {
    "nan": float("nan"),
    "big": 3.0e38,
    "-big": -3.0e38,
    "int8sat": 127.0,
}

# The reverted modes each scenario supports: every scenario carries a
# masked summary; only the slice-back seams have a full width to compare.
SCENARIO_REVERTS = {
    "pallas": ("unmasked-mean", "no-slice"),
    "mixture": ("unmasked-mean",),
    "serving": ("unmasked-mean", "no-slice"),
    "device-plane": ("unmasked-mean",),
}
CHUNKED_REFUSAL = (
    "scenario 'chunked' has no counterpart seam in the port: a chunk cut short "
    "replays one-step graphs (algos/loop.py) instead of padding to the stride and "
    "masking the tail with n_valid, so there is no masked tail to poison")


class PadSanError(RuntimeError):
    """A junk lane leaked into a valid-lane output — or a reverted mask or
    slice guard's leak was detected (the sanitizer working)."""


def _check_revert(scenario: str, revert: Optional[str]) -> None:
    if revert is not None and revert not in SCENARIO_REVERTS[scenario]:
        raise ValueError(
            f"scenario {scenario!r} supports revert modes "
            f"{SCENARIO_REVERTS[scenario]}, got {revert!r}"
        )


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _fill(poison: str, dtype) -> float:
    """The poison fill for one storage dtype: float lanes take the menu
    value; integer lanes the dtype's saturation point (NaN and 3e38 are not
    representable, and a silent wrap would make the poison garbage)."""
    dt = _np_dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return _VALUES[poison]
    info = np.iinfo(dt)
    return float(info.min if poison == "-big" else info.max)


def masked_summary(x, mask, revert: Optional[str] = None) -> bytes:
    """The guard summary every schedule routes its padded buffer through: a
    where-select masked mean (NaN-safe; a multiply-mask would propagate
    0·NaN), as float64 BYTES so the comparison is bitwise.
    `revert="unmasked-mean"` is the reverted guard: a plain mean that reads
    the junk lanes."""
    x = np.asarray(x, np.float64)
    mask = np.broadcast_to(np.asarray(mask, np.float64), x.shape)
    if revert == "unmasked-mean":
        out = np.float64(np.mean(x))
    else:
        kept = np.where(mask > 0.0, x, 0.0)
        out = np.float64(np.sum(kept) / max(float(np.sum(mask)), 1.0))
    return out.tobytes()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_bitwise(a, b, what: str, seed: int, scenario: str,
                    poison: str, report: dict) -> None:
    a, b = _host(a), _host(b)
    if not (a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()):
        report["violations"] += 1
        raise PadSanError(
            f"seed {seed}: {scenario}/{poison} poison LEAKED into "
            f"{what} — zero-fill and poison-fill runs differ "
            "(a junk lane is observable; the mask/slice/select "
            "discipline is broken at this seam)"
        )


def _assert_summary(sa: bytes, sb: bytes, seed: int, scenario: str,
                    poison: str, revert: Optional[str], report: dict) -> None:
    """The masked-summary detector: under the real seam A == B; under the
    reverted unmasked mean the poison is visible and MUST differ."""
    if revert == "unmasked-mean":
        if sa != sb:
            report["violations"] += 1
            raise PadSanError(
                f"seed {seed}: REVERTED GUARD DETECTED — the unmasked "
                f"mean read the {poison} junk lanes of the {scenario} "
                "pad buffer (zero-fill and poison-fill summaries "
                "differ); the masked where-select summary is the only "
                "thing keeping pad lanes unobservable"
            )
        raise PadSanError(  # pragma: no cover - poison fills are nonzero
            f"seed {seed}: {scenario} unmasked-mean revert NOT caught"
        )
    if sa != sb:
        report["violations"] += 1
        raise PadSanError(
            f"seed {seed}: {scenario}/{poison} poison moved the MASKED "
            "summary — the where-select mask is not covering the pad lanes"
        )


def _digest(report: dict) -> str:
    return hashlib.sha256(
        repr((report["seed"], report["scenario"], report["trace"])).encode()
    ).hexdigest()


def _sha(a) -> str:
    return hashlib.sha256(_host(a).tobytes()).hexdigest()[:16]


def _device(device) -> torch.device:
    from actor_critic_tpu_torch import resolve_device

    return resolve_device(device)


# ---------------------------------------------------------------------------
# kernel exerciser ("pallas"): the scan kernels' ragged strips and chunks
# ---------------------------------------------------------------------------

KERNEL_ES = (7, 96, 200)  # 4-byte copies at 7, 16-byte copies at 96 and 200
KERNEL_T = 100            # a 64-row chunk and a 36-row one
KERNEL_OPS = ("gae", "lambda", "vtrace")


def _kernel_inputs(op: str, E: int, nprng) -> dict:
    T = KERNEL_T

    def f(scale):
        return (nprng.normal(size=(T, E)) * scale).astype(np.float32)

    ins = {
        "rewards": f(1.0),
        "values": f(0.5),
        "dones": (nprng.random((T, E)) < 0.15).astype(np.float32),
        "bootstrap_value": (nprng.normal(size=(E,)) * 0.5).astype(np.float32),
    }
    if op == "vtrace":
        ins["target_log_probs"] = f(0.1) - 0.7
        ins["behaviour_log_probs"] = f(0.1) - 0.7
    return ins


def _tail(shape: tuple[int, ...]) -> int:
    """Elements past a [T, E] (or [E]) plane in its flat allocation: a whole
    chunk of rows and a strip of columns more, so a kernel that read or
    wrote past T or past E would land there."""
    from actor_critic_tpu_torch.ops._scan_args import SCAN_CHUNK, SCAN_COLUMNS

    return SCAN_CHUNK * shape[-1] + SCAN_COLUMNS


def _flat_plane(x: np.ndarray, fill: float, device: torch.device):
    """(flat allocation, leading view shaped as `x`): `x` as the leading
    elements of a buffer whose tail holds `fill` (contiguous: the kernels'
    wrappers require it)."""
    n = x.size
    flat = torch.full((n + _tail(x.shape),), fill, dtype=torch.float32, device=device)
    flat[:n].copy_(torch.from_numpy(x.reshape(-1)))
    return flat, flat[:n].view(x.shape)


N_OUTPUTS = {"gae": 2, "lambda": 2, "vtrace": 3}


def kernel_call(op: str, ins: dict, fill: float, device: torch.device):
    """One call of `op` through its kernel's wrapper with every input and
    output placed in a flat allocation tailed by `fill`; returns (the op's
    [T, E] outputs, the flat output allocations)."""
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    planes = {k: _flat_plane(v, fill, device)[1] for k, v in ins.items()}
    T, E = ins["rewards"].shape
    outs = [_flat_plane(np.zeros((T, E), np.float32), fill, device) for _ in range(N_OUTPUTS[op])]
    views = tuple(v for _, v in outs)
    if op == "vtrace":
        vtrace_cuda.vtrace(planes["target_log_probs"], planes["behaviour_log_probs"],
                           planes["rewards"], planes["values"], planes["dones"],
                           planes["bootstrap_value"], 0.99, out=views)
        result = views
    else:
        gae_cuda.gae(planes["rewards"], planes["values"], planes["dones"],
                     planes["bootstrap_value"], 0.99, 0.95, out=views)
        # The λ-returns are GAE's second output.
        result = views if op == "gae" else views[1:]
    return tuple(_host(v) for v in result), [_host(f) for f, _ in outs]


def exercise_kernels(seed: int, revert: Optional[str] = None, rounds: int = 2,
                     device="cuda") -> dict:
    """Poisoned allocation tails around the scan kernels' ragged edges (the
    "pallas" scenario): the A-run's inputs and outputs sit in allocations
    tailed by zeros, the B-run's by the poison, and the [T, E] outputs must
    be bitwise those of the A-run with every output tail untouched: a read
    past E or T would move an output, a write past them would move a tail.
    `revert="no-slice"` compares the FULL output allocations instead, whose
    tails differ by construction and must be caught."""
    _check_revert("pallas", revert)
    dev = _device(device)
    rng = random.Random(seed)
    report = {
        "seed": seed, "scenario": "pallas", "revert": revert,
        "programs": 0, "violations": 0, "trace": [],
    }
    for round_ in range(rounds):
        nprng = np.random.default_rng(seed * 67 + round_)
        op = KERNEL_OPS[rng.randrange(len(KERNEL_OPS))]
        E = KERNEL_ES[rng.randrange(len(KERNEL_ES))]
        poison = POISONS[rng.randrange(len(POISONS))]
        fill = _fill(poison, np.float32)
        ins = _kernel_inputs(op, E, nprng)
        (out_a, flat_a), (out_b, flat_b) = (kernel_call(op, ins, f, dev) for f in (0.0, fill))
        report["programs"] += 2
        if revert == "no-slice":
            for a, b in zip(flat_a, flat_b):
                if a.tobytes() != b.tobytes():
                    report["violations"] += 1
                    raise PadSanError(
                        f"seed {seed}: REVERTED GUARD DETECTED — "
                        f"committing the full allocation of the {op} "
                        f"kernel's outputs exposes the {poison} tail "
                        "(zero-fill and poison-fill outputs differ); "
                        "the [T, E] view is the guard"
                    )
            raise PadSanError(  # pragma: no cover - tails always differ
                f"seed {seed}: pallas no-slice revert NOT caught")
        for i, (a, b) in enumerate(zip(out_a, out_b)):
            _assert_bitwise(a, b, f"{op} output {i} (valid lanes)", seed, "pallas",
                            poison, report)
        n = KERNEL_T * E
        for fa, fb in zip(flat_a, flat_b):
            for flat, want in ((fa, 0.0), (fb, fill)):
                tail = flat[n:]
                expect = np.full(tail.shape, want, np.float32)
                if tail.tobytes() != expect.tobytes():
                    report["violations"] += 1
                    raise PadSanError(
                        f"seed {seed}: pallas/{poison}: the {op} kernel WROTE past "
                        f"its [T={KERNEL_T}, E={E}] output into the allocation's tail"
                    )
        wide_a = np.concatenate([ins["rewards"].reshape(-1), np.zeros(_tail(ins["rewards"].shape))])
        wide_b = np.concatenate([ins["rewards"].reshape(-1),
                                 np.full(_tail(ins["rewards"].shape), fill)])
        mask = (np.arange(wide_a.size) < n).astype(np.float64)
        _assert_summary(masked_summary(wide_a, mask, revert),
                        masked_summary(wide_b, mask, revert),
                        seed, "pallas", poison, revert, report)
        report["trace"].append((round_, op, E, poison, [_sha(a) for a in out_a]))
    report["digest"] = _digest(report)
    return report


# ---------------------------------------------------------------------------
# mixture exerciser: the parked member slots
# ---------------------------------------------------------------------------

_MIX_FIXTURES: dict = {}


def _mixture_fixture():
    if "env" not in _MIX_FIXTURES:
        from actor_critic_tpu_torch.envs.mixture import make_mixture

        _MIX_FIXTURES["env"] = make_mixture("cartpole,pendulum,acrobot,maze")
    return _MIX_FIXTURES["env"]


def _fill_members(members, live: int, fill: float):
    """Every float leaf of every PARKED member state set to `fill` (other
    leaves, the step counters, pass through)."""
    from actor_critic_tpu_torch.tree import tree_map

    def one(m):
        return tree_map(lambda a: torch.full_like(a, fill) if a.is_floating_point() else a, m)

    return tuple(m if i == live else one(m) for i, m in enumerate(members))


def _member_float_plane(members, live: int):
    """(flat float64 values, validity mask) over every float leaf of every
    member: the padded buffer the guard summary reads."""
    from actor_critic_tpu_torch.tree import tree_leaves

    vals, mask = [], []
    for i, m in enumerate(members):
        for leaf in tree_leaves(m):
            if not leaf.is_floating_point():
                continue
            flat = _host(leaf).astype(np.float64).ravel()
            vals.append(flat)
            mask.append(np.full(flat.shape, float(i == live)))
    return np.concatenate(vals), np.concatenate(mask)


def exercise_mixture(seed: int, revert: Optional[str] = None, rounds: int = 2,
                     device="cuda") -> dict:
    """Poisoned PARKED members through the REAL mixture step: the fleet keeps
    every member type's state and takes only the live member's outputs, so
    a parked slot is the mixture's padding lane. Filling the 3 parked
    states with the poison must leave the live transition (obs, reward,
    done, terminated, final_obs) and the live member's next state bitwise
    unchanged, and the padded obs lanes past the live width exactly 0.0."""
    from actor_critic_tpu_torch.tree import tree_leaves

    _check_revert("mixture", revert)
    dev = _device(device)
    env = _mixture_fixture()
    n_types = len(env.member_names)
    rng = random.Random(seed)
    report = {
        "seed": seed, "scenario": "mixture", "revert": revert,
        "programs": 0, "violations": 0, "trace": [],
    }
    for round_ in range(rounds):
        live = rng.randrange(n_types)
        poison = POISONS[rng.randrange(len(POISONS))]
        fill = _fill(poison, np.float32)
        key = seed * 73 + round_
        state, _obs0 = env.reset_typed(1, torch.Generator(device=dev).manual_seed(key), live)
        action = torch.tensor([rng.randrange(env.spec.action_dim)], dtype=torch.int64,
                              device=dev)
        outs = []
        for pad_fill in (0.0, fill):
            s = state._replace(members=_fill_members(state.members, live, pad_fill))
            # The same generator state for both runs: a step's draws do not
            # depend on the values it steps.
            gen = torch.Generator(device=dev).manual_seed(key + 1)
            outs.append(env.step(s, action, gen))
            report["programs"] += 1
        out_a, out_b = outs
        for name, a, b in (
            ("obs", out_a.obs, out_b.obs),
            ("reward", out_a.reward, out_b.reward),
            ("done", out_a.done, out_b.done),
            ("terminated", out_a.info["terminated"], out_b.info["terminated"]),
            ("final_obs", out_a.info["final_obs"], out_b.info["final_obs"]),
        ):
            _assert_bitwise(a, b, f"the live transition's {name}", seed, "mixture",
                            poison, report)
        for la, lb in zip(tree_leaves(out_a.state.members[live]),
                          tree_leaves(out_b.state.members[live])):
            _assert_bitwise(la, lb, "the live member's next state", seed, "mixture",
                            poison, report)
        width = env.member_specs[live].obs_shape[0]
        dead = _host(out_b.obs)[..., width:]
        if dead.size and (dead != 0.0).any():
            report["violations"] += 1
            raise PadSanError(
                f"seed {seed}: mixture/{poison} poison reached the "
                f"padded obs lanes past width {width} — the mask "
                "multiply of the mixture's pad is not holding them at 0.0"
            )
        va, ma = _member_float_plane(_fill_members(state.members, live, 0.0), live)
        vb, _ = _member_float_plane(_fill_members(state.members, live, fill), live)
        _assert_summary(masked_summary(va, ma, revert), masked_summary(vb, ma, revert),
                        seed, "mixture", poison, revert, report)
        report["trace"].append((round_, env.member_names[live], poison, _sha(out_a.obs)))
    report["digest"] = _digest(report)
    return report


# ---------------------------------------------------------------------------
# serving exerciser: PolicyEngine.act's bucket backfill rows
# ---------------------------------------------------------------------------

_SERVE_FIXTURES: dict = {}


def serving_fixture(device="cuda"):
    """One REAL warmed `PolicyEngine` per device (on the card: a CUDA graph
    per bucket, captured by `warm`), built once per process. The DDPG tanh
    actor on the point mass: its pad-row outputs under poison (tanh(±huge)
    = ±1, NaN stays NaN) always differ from the zero fill's, so the
    no-slice revert shows on every schedule."""
    dev = _device(device)
    if str(dev) not in _SERVE_FIXTURES:
        from actor_critic_tpu_torch.algos.ddpg import DDPGConfig
        from actor_critic_tpu_torch.envs.testbeds import make_point_mass
        from actor_critic_tpu_torch.serving import engine as serving

        spec = make_point_mass().spec
        cfg = DDPGConfig(hidden=(16, 16))
        eng = serving.PolicyEngine(spec, cfg, algo="ddpg", buckets=(1, 2, 4, 8), device=dev)
        params = eng.prepare_params(serving.init_params(spec, cfg, "ddpg", seed=0))
        eng.warm(params)
        _SERVE_FIXTURES[str(dev)] = (eng, params)
    return _SERVE_FIXTURES[str(dev)]


def exercise_serving(seed: int, revert: Optional[str] = None, rounds: int = 2,
                     device="cuda") -> dict:
    """Poisoned bucket-backfill rows through the REAL `PolicyEngine.act`:
    ragged n pads to its bucket through the engine's `pad_to_bucket`, and
    the B-run's seam wrapper fills the standby rows with the poison; the n
    returned actions must be bitwise those of the zero fill (the MLP is
    row-independent and act returns [:n]). `revert="no-slice"` dispatches
    the padded batch through the lane directly and compares the FULL
    bucket: the junk rows' actions differ by construction and must be
    caught."""
    from actor_critic_tpu_torch.serving import engine as engine_mod

    _check_revert("serving", revert)
    eng, params = serving_fixture(device)
    rng = random.Random(seed)
    report = {
        "seed": seed, "scenario": "serving", "revert": revert,
        "programs": 0, "violations": 0, "trace": [],
    }
    for round_ in range(rounds):
        nprng = np.random.default_rng(seed * 79 + round_)
        n = (3, 5, 6, 7)[rng.randrange(4)]  # never a bucket size: backfill engages
        poison = POISONS[rng.randrange(len(POISONS))]
        fill = _fill(poison, np.float32)
        obs = (nprng.normal(size=(n, 1)) * 0.7).astype(np.float32)
        padded, mask = engine_mod.pad_to_bucket(obs, eng.buckets)
        padded_p = padded.copy()
        padded_p[n:] = fill

        if revert == "no-slice":
            outs = []
            for batch in (padded, padded_p):
                outs.append(np.asarray(eng._run(params, batch)))
                report["programs"] += 1
            if outs[0].tobytes() != outs[1].tobytes():
                report["violations"] += 1
                raise PadSanError(
                    f"seed {seed}: REVERTED GUARD DETECTED — returning "
                    f"the full bucket width exposes the {poison} "
                    f"standby rows past n={n} (zero-fill and "
                    "poison-fill actions differ); act()'s [:n] slice "
                    "is the guard"
                )
            raise PadSanError(  # pragma: no cover - rows always differ
                f"seed {seed}: serving no-slice revert NOT caught")

        acts_a = eng.act(params, obs)
        report["programs"] += 1
        orig = engine_mod.pad_to_bucket

        def poisoned_pad(x, buckets, axis=0):
            out, m = orig(x, buckets, axis)
            out = np.array(out)
            out[x.shape[0]:] = fill
            return out, m

        engine_mod.pad_to_bucket = poisoned_pad
        try:
            acts_b = eng.act(params, obs)
            report["programs"] += 1
        finally:
            engine_mod.pad_to_bucket = orig
        _assert_bitwise(acts_a, acts_b, f"the first-{n} actions", seed, "serving",
                        poison, report)
        _assert_summary(masked_summary(padded, mask[:, None], revert),
                        masked_summary(padded_p, mask[:, None], revert),
                        seed, "serving", poison, revert, report)
        report["trace"].append((round_, n, poison, _sha(acts_a)))
    report["digest"] = _digest(report)
    return report


# ---------------------------------------------------------------------------
# device-plane exerciser: ring slots outside the leased gather
# ---------------------------------------------------------------------------


def exercise_device_plane(seed: int, revert: Optional[str] = None, rounds: int = 2,
                          device="cuda") -> dict:
    """Poisoned NON-leased slots through the REAL `DeviceTrajRing` +
    `gather_block`: a depth-3 ring on `device` holds one real block, every
    OTHER slot's storage is filled with the poison (int8 storage takes the
    saturating integer fill), and the leased slot's decode must be bitwise
    unchanged: the gather reads exactly one slot, so a neighbouring slot is
    a padding lane. A fresh ring per round keeps the int8 calibration
    local to the schedule."""
    from actor_critic_tpu_torch.data_plane import ring as ring_mod

    _check_revert("device-plane", revert)
    dev = _device(device)
    rng = random.Random(seed)
    report = {
        "seed": seed, "scenario": "device-plane", "revert": revert,
        "programs": 0, "violations": 0, "trace": [],
    }
    depth = 3
    spec = {
        "obs": ring_mod.array_spec((4, 6, 3), np.float32),
        "reward": ring_mod.array_spec((4, 6), np.float32),
        "action": ring_mod.array_spec((4, 6), np.int32),
    }
    for round_ in range(rounds):
        nprng = np.random.default_rng(seed * 83 + round_)
        kind = ("fp32", "int8")[rng.randrange(2)]
        poison = POISONS[rng.randrange(len(POISONS))]
        ring = ring_mod.DeviceTrajRing(depth, spec, codec=kind, register_gauge=False,
                                       device=dev)
        block = {
            "obs": (nprng.normal(size=(4, 6, 3)) * 0.8).astype(np.float32),
            "reward": (nprng.normal(size=(4, 6)) * 0.5).astype(np.float32),
            "action": nprng.integers(0, 5, (4, 6)).astype(np.int32),
        }
        if not ring.put(block, version=round_):
            raise PadSanError(f"seed {seed}: the device-plane ring refused its one block")
        lease = ring.get()
        ring.select(lease)

        def decode():
            out = ring_mod.gather_block(ring.state, ring.slot_index, ring.codecs)
            return {k: _host(v) for k, v in out.items()}

        out_a = decode()
        report["programs"] += 1
        sel = torch.arange(depth, device=dev) != lease.slot
        with torch.no_grad():
            for store in ring.state.storage.values():
                store[sel] = _fill(poison, store.dtype)
        out_b = decode()
        report["programs"] += 1
        for name in sorted(out_a):
            _assert_bitwise(out_a[name], out_b[name], f"the leased slot's decoded {name!r}",
                            seed, "device-plane", poison, report)
        slot_mask = (np.arange(depth) == lease.slot).astype(np.float64)
        plane_a = np.zeros((depth, 4, 6), np.float64)
        plane_b = np.full((depth, 4, 6), float(_fill(poison, np.float32)), np.float64)
        block_plane = np.asarray(block["reward"], np.float64)
        plane_a[lease.slot] = block_plane
        plane_b[lease.slot] = block_plane
        _assert_summary(masked_summary(plane_a, slot_mask[:, None, None], revert),
                        masked_summary(plane_b, slot_mask[:, None, None], revert),
                        seed, "device-plane", poison, revert, report)
        ring.release(lease)
        ring.close()
        report["trace"].append((round_, kind, poison, int(lease.slot),
                                {k: _sha(v) for k, v in sorted(out_a.items())}))
    report["digest"] = _digest(report)
    return report


EXERCISERS = {
    "pallas": exercise_kernels,
    "mixture": exercise_mixture,
    "serving": exercise_serving,
    "device-plane": exercise_device_plane,
}


# ---------------------------------------------------------------------------
# sweep + the quick profile
# ---------------------------------------------------------------------------


def exercise_sweep(seeds: Iterable[int], scenario) -> dict:
    reports = [scenario(seed) for seed in seeds]
    return {
        "schedules": len(reports),
        "programs": sum(r.get("programs", 0) for r in reports),
        "violations": sum(r.get("violations", 0) for r in reports),
    }


def quick_profile(schedules: int = 16, seed0: int = 0, device="cuda") -> dict:
    """The fast profile: `schedules` seeded poison schedules split across the
    four seams (JAX's five without `chunked`); every pad seam must keep its
    junk lanes unobservable, bitwise."""
    n = max(schedules // 4, 1)
    parts = {}
    for i, (name, fn) in enumerate(EXERCISERS.items()):
        count = n if i < len(EXERCISERS) - 1 else schedules - 3 * n
        parts[name.replace("-", "_")] = exercise_sweep(
            range(seed0, seed0 + count), lambda s, fn=fn: fn(s, device=device))
    return {
        "schedules": sum(x["schedules"] for x in parts.values()),
        **parts,
        "programs": sum(x["programs"] for x in parts.values()),
        "violations": sum(x["violations"] for x in parts.values()),
    }


def main(argv=None) -> int:
    """The CLI (JAX's `scripts/padsan.py`, with `--device`)."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        prog="python -m actor_critic_tpu_torch.analysis.padsan",
        description="deterministic padding-lane poison sanitizer")
    p.add_argument("--schedules", type=int, default=16,
                   help="seeded poison schedules to sweep (default 16, the quick profile: split "
                   "across pallas/mixture/serving/device-plane)")
    p.add_argument("--seed0", type=int, default=0,
                   help="first seed of the sweep (a violation names its seed for replay)")
    p.add_argument("--scenario",
                   choices=("all", "chunked", "pallas", "mixture", "serving", "device-plane"),
                   default="all",
                   help="which pad seam to exercise (default: the quick profile; 'pallas' the "
                   "GAE/λ/V-trace kernels' ragged strips and chunks, 'mixture' the fleet's "
                   "parked members, 'serving' PolicyEngine.act's bucket backfill rows, "
                   "'device-plane' the ring slots outside the leased gather; 'chunked' has no "
                   "counterpart seam in the port and is refused)")
    p.add_argument("--revert", choices=("unmasked-mean", "no-slice"), default=None,
                   help="reverted-guard mode (expected exit 1): 'unmasked-mean' swaps the masked "
                   "where-select summary for a plain mean (any scenario); 'no-slice' commits "
                   "the full padded width instead of the valid part (pallas, serving)")
    p.add_argument("--quick", action="store_true",
                   help="alias for the default quick profile")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the programs run (default: the card)")
    args = p.parse_args(argv)

    if args.scenario == "chunked":
        print(f"padsan: error: {CHUNKED_REFUSAL}", file=sys.stderr)
        return 2
    if args.revert is not None:
        if args.scenario == "all":
            print("padsan: error: --revert needs a single --scenario (the quick profile only "
                  "sweeps the guarded modes)", file=sys.stderr)
            return 2
        if args.revert not in SCENARIO_REVERTS[args.scenario]:
            print(f"padsan: error: scenario {args.scenario!r} supports revert modes "
                  f"{SCENARIO_REVERTS[args.scenario]}, got {args.revert!r}", file=sys.stderr)
            return 2
    try:
        if args.scenario == "all":
            out = quick_profile(schedules=args.schedules, seed0=args.seed0, device=args.device)
        else:
            fn = EXERCISERS[args.scenario]
            out = exercise_sweep(range(args.seed0, args.seed0 + args.schedules),
                                 lambda s: fn(s, revert=args.revert, device=args.device))
    except PadSanError as e:
        print(f"padsan: VIOLATION DETECTED: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"padsan: error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(out, indent=2, default=str))
    else:
        print(f"padsan: {out.get('schedules', 0)} poison schedule(s) clean — no pad lane "
              "leaked a byte into a valid-lane output")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
