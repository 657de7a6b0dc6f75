"""numsan: deterministic NaN/Inf/saturation fault sanitizer (counterpart of
`actor_critic_tpu/analysis/numsan.py`).

Each seeded schedule poisons EXACTLY ONE element of one designated leaf
(rewards, observations, a post-update parameter tree, quantizer stats, a
published snapshot) with one fault of the menu

    nan        quiet NaN
    inf/-inf   ±infinity
    denormal   a float32 subnormal (~1e-42): must be TOLERATED everywhere
               (the guards must not over-fire)
    saturate   an int8/f16-saturating magnitude (3.7e5): the codecs must
               clip to their range, never wrap or overflow

inside the port's REAL objects: `ppo.make_host_update_step` (the host PPO
update, whose advantages go through the GAE kernel on the card), the device
codecs of `replay/quantize.py` against the numpy mirror of
`data_plane/codecs.py`, `PolicyPublisher`, `multihost.write_params` /
`read_params`, `PolicyStore.swap`, and the `Checkpointer`. It asserts the
stack's NAMED response:

- **divergence event**: a nonfinite reward/obs poison surfaces as a
  non-finite loss that fires `telemetry/health.py::DivergenceMonitor`'s
  `non_finite_loss`;
- **checkpoint refusal**: `Checkpointer.save` of a poisoned state raises
  `NonFiniteError`, and the previous step stays the latest and restores;
- **publish/mailbox/swap rejection**: each refuses, and the previous good
  snapshot stays visible;
- **codec saturation**: the int8 codecs give exactly ±127 (bool8 {0, 1},
  f16 ±65504) for saturating or infinite inputs and encode NaN to the
  midpoint, and the numpy mirror equals the device codec bit for bit under
  poison.

A failed assertion raises `NumSanError`; a clean schedule appends to
`report["trace"]`, the same for every run of a seed. The poison and leaf
draws are Python's `random.Random` over JAX's leaf enumeration, so a seed
poisons what JAX's exerciser poisons wherever the trees' leaves correspond.
**Reverted-guard modes** prove the detectors work: `revert=True` of
`exercise_publish`, `exercise_checkpoint` and `exercise_bf16_update` no-ops
`numguard.check_finite`, the one seam every commit gate goes through, and
numsan must catch the poison past the sink; `exercise_codec(revert=True)`
runs the pre-fix wrapping encoder against the saturation check.

    python -m actor_critic_tpu_torch.analysis.numsan                  # quick profile
    python -m actor_critic_tpu_torch.analysis.numsan --scenario publish --revert
    python -m actor_critic_tpu_torch.analysis.numsan --device cpu

Exit codes: 0 clean, 1 violation (or a reverted guard caught), 2 crash or
usage error. The exercisers run on the card unless `device="cpu"`.
"""

from __future__ import annotations

import math
import random
import tempfile
from typing import Iterable

import numpy as np
import torch

from actor_critic_tpu_torch.utils import numguard

POISONS = ("nan", "inf", "-inf", "denormal", "saturate")
NONFINITE = ("nan", "inf", "-inf")
_VALUES = {
    "nan": float("nan"),
    "inf": float("inf"),
    "-inf": float("-inf"),
    "denormal": 1e-42,
    "saturate": 3.7e5,
}


class NumSanError(RuntimeError):
    """A guard failed to block (or tolerate) a poison — or a reverted
    guard's leak was detected (the sanitizer working)."""


def _flat_float_leaves(tree, path=""):
    """[(path, array)] of the float leaves of a numpy tree, sorted by path:
    the stable enumeration the seeded leaf choice indexes into."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flat_float_leaves(tree[k], f"{path}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(_flat_float_leaves(v, f"{path}[{i}]"))
    elif isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype, np.floating):
        out.append((path, tree))
    return out


def _poison_tree(tree, rng: random.Random, poison: str):
    """Poison ONE element of ONE float leaf of a writable numpy tree;
    returns (leaf path, flat index)."""
    leaves = _flat_float_leaves(tree)
    if not leaves:
        raise ValueError("no float leaves to poison")
    path, arr = leaves[rng.randrange(len(leaves))]
    idx = rng.randrange(max(arr.size, 1))
    arr.reshape(-1)[idx] = _VALUES[poison]
    return path, idx


class _guards_disabled:
    """No-ops `numguard.check_finite` (the reverted-guard mode): every
    commit gate goes through this one attribute, so one seam reverts all."""

    def __enter__(self):
        self._orig = numguard.check_finite
        numguard.check_finite = lambda *a, **k: None
        return self

    def __exit__(self, *exc):
        numguard.check_finite = self._orig


def _device(device) -> torch.device:
    from actor_critic_tpu_torch import resolve_device

    return resolve_device(device)


def _tensors(tree, device: torch.device):
    """A numpy tree as the same tree of tensors on `device` (copies)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def _numpy(tree):
    """A tree of tensors (or arrays) as a writable numpy deep copy."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)


def _checkpoint_state(tree, device: torch.device):
    """A numpy tree as the checkpointable state the port's `Checkpointer`
    saves (`host_loop.HostCheckpoint`: tensors by name and a generator)."""
    from actor_critic_tpu_torch.algos.host_loop import HostCheckpoint

    return HostCheckpoint(generator=torch.Generator().manual_seed(0),
                          device_state=_tensors(tree, device), pool={})


# ---------------------------------------------------------------------------
# update exerciser: the real host PPO update + DivergenceMonitor
# ---------------------------------------------------------------------------

_UPDATE_FIXTURES: dict = {}


class _UpdateFixture:
    """One tiny REAL host-PPO update (`ppo.make_host_update_step`) on
    `device`, built once per process and configuration. The update writes
    the network and Adam state in place, so `run` restores both (and the
    permutation generator) before every call: each schedule sees the same
    parameters, as JAX's functional update does."""

    def __init__(self, device: torch.device, bf16: bool):
        from actor_critic_tpu_torch.algos import ppo
        from actor_critic_tpu_torch.envs.env import EnvSpec

        spec = EnvSpec(obs_shape=(4,), action_dim=2, discrete=True, can_truncate=True)
        self.cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=1, num_minibatches=1,
                                 hidden=(8,), bf16_compute=bf16)
        self.device = device
        self.net, self.opt_state = ppo.init_host_params(spec, self.cfg, 0, device)
        self.schedule = ppo.make_schedule(self.cfg, device)
        self.generator = torch.Generator(device=device).manual_seed(0)
        self.update = ppo.make_host_update_step(spec, self.cfg)
        self._params = {k: p.detach().clone() for k, p in self.net.named_parameters()}
        self._moments = [t.clone() for t in self._opt_tensors()]
        self._gen_state = self.generator.get_state()

    def _opt_tensors(self) -> list[torch.Tensor]:
        st = self.opt_state
        return [st.count, *st.mu.values(), *st.nu.values()]

    def run(self, block: dict) -> dict:
        with torch.no_grad():
            for k, p in self.net.named_parameters():
                p.copy_(self._params[k])
            for t, saved in zip(self._opt_tensors(), self._moments):
                t.copy_(saved)
        self.generator.set_state(self._gen_state)
        tensors = {k: torch.from_numpy(v).to(self.device) for k, v in block.items()}
        return self.update(self.net, self.opt_state, self.schedule, self.generator, tensors,
                           None)


def _update_fixture(device: torch.device, bf16: bool = False) -> _UpdateFixture:
    key = (str(device), bf16)
    if key not in _UPDATE_FIXTURES:
        _UPDATE_FIXTURES[key] = _UpdateFixture(device, bf16)
    return _UPDATE_FIXTURES[key]


def _synth_block(cfg, nprng: np.random.Generator) -> dict:
    T, E = cfg.rollout_steps, cfg.num_envs
    return {
        "obs": nprng.normal(size=(T, E, 4)).astype(np.float32),
        "action": nprng.integers(0, 2, (T, E)),
        "log_prob": (nprng.normal(size=(T, E)) * 0.1 - 0.69).astype(np.float32),
        "value": nprng.normal(size=(T, E)).astype(np.float32),
        "reward": np.ones((T, E), np.float32),
        "done": np.zeros((T, E), np.float32),
        "terminated": np.zeros((T, E), np.float32),
        "final_obs": nprng.normal(size=(T, E, 4)).astype(np.float32),
        "last_obs": nprng.normal(size=(E, 4)).astype(np.float32),
    }


def exercise_update(seed: int, rounds: int = 2, device="cuda") -> dict:
    """Seeded poisons (rewards or obs) through the REAL update: nonfinite
    poisons must surface as a non-finite loss that fires the
    DivergenceMonitor's `non_finite_loss`; denormal and saturating poisons
    must leave the loss finite and the monitor quiet."""
    from actor_critic_tpu_torch.telemetry.health import DivergenceMonitor

    fx = _update_fixture(_device(device))
    rng = random.Random(seed)
    report = {
        "seed": seed, "scenario": "update", "trace": [],
        "divergence_events": 0, "violations": 0,
    }
    for round_ in range(rounds):
        block = _synth_block(fx.cfg, np.random.default_rng(seed * 31 + round_))
        target = ("reward", "obs")[rng.randrange(2)]
        # Per-target menus, JAX's: an ±inf observation is squashed finite
        # by the tanh torso (tanh(±inf) = ±1), so only nan survives the
        # forward pass from obs; rewards flow linearly through GAE.
        menu = POISONS if target == "reward" else ("nan", "denormal", "saturate")
        poison = menu[rng.randrange(len(menu))]
        _, idx = _poison_tree({target: block[target]}, rng, poison)
        metrics = fx.run(block)
        loss = float(metrics["loss"])
        events: list = []
        monitor = DivergenceMonitor(lambda kind, **f: events.append((kind, f)))
        monitor.observe(round_, {"loss": loss})
        fired = [f for kind, f in events
                 if kind == "divergence" and f.get("reason") == "non_finite_loss"]
        if poison in NONFINITE:
            if math.isfinite(loss):
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: {poison} poison of {target}[{idx}] "
                    f"vanished — the loss came out finite ({loss!r}); "
                    "the update is masking non-finites instead of "
                    "surfacing them to the DivergenceMonitor"
                )
            if not fired:
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: non-finite loss {loss!r} did NOT "
                    "fire DivergenceMonitor non_finite_loss — the "
                    "divergence guard is reverted/blind"
                )
            report["divergence_events"] += 1
        else:
            if not math.isfinite(loss):
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: tolerated poison {poison} of "
                    f"{target}[{idx}] made the loss non-finite "
                    f"({loss!r}) — denormal/large-but-finite inputs "
                    "must train through"
                )
            if fired:
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: DivergenceMonitor fired on a finite "
                    f"loss {loss!r} — the guard over-fires"
                )
        report["trace"].append(
            (round_, target, poison, idx, repr(loss), "divergence" if fired else "clean"))
    return report


# ---------------------------------------------------------------------------
# publish exerciser: PolicyPublisher + file mailbox + PolicyStore.swap
# ---------------------------------------------------------------------------


class _StubEngine:
    max_rows = 8

    def prepare_params(self, params):
        out = {k: np.array(v) for k, v in params.items()}
        for v in out.values():
            v.flags.writeable = False
        return out

    def act(self, params, obs):
        return np.asarray(obs)[:, 0] * params["w"].flat[0]


def _params_tree(fill: float = 1.0) -> dict:
    return {
        "w": np.full((3, 2), fill, np.float32),
        "b": np.full((2,), fill, np.float32),
    }


def _flat_dict(tree) -> dict:
    """{leaf path: array} of a nested numpy tree, sorted by path: the flat
    `{name: array}` form the file mailbox takes."""
    return dict(_flat_float_leaves(tree))


def exercise_publish(seed: int, revert: bool = False) -> dict:
    """Seeded poisons against the three publish-shaped gates of the REAL
    objects: `PolicyPublisher.publish`, `write_params` (read back by
    `read_params`) and `PolicyStore.swap`. Nonfinite: all three refuse and
    the previous snapshot stays visible; denormal: all three accept. With
    `revert=True` the gates are no-op'd and the check must CATCH the poison
    past each sink. Host objects: nothing here runs on the card."""
    from actor_critic_tpu_torch.algos.traj_queue import PolicyPublisher
    from actor_critic_tpu_torch.parallel.multihost import read_params, write_params
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore

    rng = random.Random(seed)
    # The reverted mode draws nonfinite poisons only: every schedule must
    # detect the leak (a denormal leaks nothing).
    menu = NONFINITE if revert else (NONFINITE + ("denormal",))
    poison = menu[rng.randrange(len(menu))]
    report = {
        "seed": seed, "scenario": "publish", "poison": poison,
        "trace": [], "rejections": 0, "violations": 0,
    }
    good = _params_tree(0.5)
    poisoned = _params_tree(0.5)
    path, idx = _poison_tree(poisoned, rng, poison)

    publisher = PolicyPublisher(good, version=1)
    store = PolicyStore()
    store.register("default", _StubEngine(), good, version=1)
    with tempfile.TemporaryDirectory(prefix="numsan_") as mailbox:
        write_params(mailbox, 0, 1, good)

        def attempt(fn):
            try:
                fn()
            except numguard.NonFiniteError:
                report["rejections"] += 1
                return "rejected"
            return "accepted"

        sinks = [
            ("publish", lambda: publisher.publish(poisoned, 2)),
            ("write_params", lambda: write_params(mailbox, 0, 2, poisoned)),
            ("swap", lambda: store.swap("default", poisoned, version=2)),
        ]
        if revert:
            with _guards_disabled():
                for name, fn in sinks:
                    report["trace"].append((name, poison, path, idx, attempt(fn)))
            leaked = []
            if numguard.nonfinite_leaves(publisher.get()[1]):
                leaked.append("publisher")
            out = read_params(mailbox, 0, good)
            if out is not None and numguard.nonfinite_leaves(out[1]):
                leaked.append("mailbox")
            if numguard.nonfinite_leaves(dict(store.get("default").params)):
                leaked.append("store")
            if leaked:
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: REVERTED GUARD DETECTED — "
                    f"{poison} poison at {path}[{idx}] reached "
                    f"{'/'.join(leaked)} with check_finite no-op'd "
                    "(the commit gates are the only thing standing "
                    "between a diverged learner and the fleet/clients)"
                )
            return report
        for name, fn in sinks:
            outcome = attempt(fn)
            report["trace"].append((name, poison, path, idx, outcome))
            if poison in NONFINITE and outcome != "rejected":
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: {name} ACCEPTED a {poison}-poisoned "
                    f"tree ({path}[{idx}]) — the finiteness gate is "
                    "missing/reverted"
                )
            if poison == "denormal" and outcome != "accepted":
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: {name} rejected a denormal — the "
                    "gate over-fires (only nan/±inf may refuse)"
                )
        version, params = publisher.get()
        if numguard.nonfinite_leaves(params) or (poison in NONFINITE and version != 1):
            raise NumSanError(f"seed {seed}: publisher lost its good snapshot")
        out = read_params(mailbox, 0, good)
        if poison in NONFINITE and (
            out is None or out[0] != 1 or numguard.nonfinite_leaves(out[1])
        ):
            raise NumSanError(f"seed {seed}: mailbox lost its good snapshot")
        if poison in NONFINITE and store.get("default").version != 1:
            raise NumSanError(f"seed {seed}: store swapped despite the refusal")
    return report


# ---------------------------------------------------------------------------
# checkpoint exerciser: the port's Checkpointer (quant stats ride too)
# ---------------------------------------------------------------------------


def exercise_checkpoint(seed: int, revert: bool = False, device="cuda") -> dict:
    """Seeded poisons against the checkpoint commit gate: the REAL
    `Checkpointer` saves a finite state (tensors on `device`) at step 0; the
    poisoned state (params OR the quant-stat leaves beside them) must be
    refused at step 1 with step 0 still the latest and restorable.
    `revert=True` no-ops the gate and the check must find the poisoned
    commit in the restored state."""
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    dev = _device(device)
    rng = random.Random(seed)
    menu = NONFINITE if revert else (NONFINITE + ("denormal",))
    poison = menu[rng.randrange(len(menu))]
    report = {
        "seed": seed, "scenario": "checkpoint", "poison": poison,
        "trace": [], "refusals": 0, "violations": 0,
    }
    state = {
        "params": _params_tree(0.25),
        "quant_stats": {
            "mean": np.zeros((4,), np.float32),
            "scale": np.full((4,), 1e-6, np.float32),
        },
    }
    with tempfile.TemporaryDirectory(prefix="numsan_ckpt_") as root:
        ckpt = Checkpointer(root, max_to_keep=2)
        ckpt.save(0, _checkpoint_state(state, dev))
        path, idx = _poison_tree(state, rng, poison)
        outcome = "accepted"
        if revert:
            with _guards_disabled():
                ckpt.save(1, _checkpoint_state(state, dev))
        else:
            try:
                ckpt.save(1, _checkpoint_state(state, dev))
            except numguard.NonFiniteError:
                outcome = "refused"
                report["refusals"] += 1
        report["trace"].append((poison, path, idx, outcome))
        latest = ckpt.latest_step()
        template = _checkpoint_state({
            "params": _params_tree(0.0),
            "quant_stats": {"mean": np.zeros((4,), np.float32),
                            "scale": np.zeros((4,), np.float32)},
        }, dev)
        ckpt.restore(template, latest)
        bad = numguard.nonfinite_leaves(_numpy(template.device_state))
        if revert and poison in NONFINITE:
            if latest == 1 and bad:
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: REVERTED GUARD DETECTED — "
                    f"{poison} poison at {path}[{idx}] COMMITTED "
                    "at step 1 and restores poisoned (every "
                    "future resume now inherits it)"
                )
            return report
        if poison in NONFINITE:
            if outcome != "refused":
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: checkpoint COMMITTED a {poison}-"
                    f"poisoned state ({path}[{idx}]) — the commit "
                    "gate is missing/reverted"
                )
            if latest != 0 or bad:
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: refusal did not preserve the "
                    f"previous good checkpoint (latest={latest})"
                )
        elif outcome != "accepted" or latest != 1:
            report["violations"] += 1
            raise NumSanError(
                f"seed {seed}: checkpoint refused a denormal — "
                "the gate over-fires"
            )
    return report


# ---------------------------------------------------------------------------
# bf16-update exerciser: the --update-dtype bf16 update feeds the gates
# ---------------------------------------------------------------------------


class _TreeStubEngine:
    """`_StubEngine` for nested (real-network) param trees: prepare flattens
    to a path → array dict, so the far side of `PolicyStore.swap` stays
    leaf-checkable under the reverted-guard mode."""

    max_rows = 8

    def prepare_params(self, params):
        out = {p: np.array(a) for p, a in _flat_float_leaves(params)}
        for v in out.values():
            v.flags.writeable = False
        return out

    def act(self, params, obs):
        first = sorted(params)[0]
        return np.asarray(obs)[:, 0] * float(params[first].flat[0])


def exercise_bf16_update(seed: int, revert: bool = False, device="cuda") -> dict:
    """The bf16-update poison schedule. First the REAL `bf16_compute=True`
    update (`--update-dtype bf16`: bf16 products, float32 parameters,
    optimizer state and loss accumulation) runs on a CLEAN block on
    `device` and its loss must come out finite. Then the POST-UPDATE
    float32 parameters (in flax's layout, `weights.to_flax`: JAX's leaf
    paths) are poisoned, and the gates the float32 path relies on must
    refuse them at every sink: published (`PolicyPublisher.publish`,
    `write_params`), checkpointed (`Checkpointer`) and served
    (`PolicyStore.swap`). Denormals pass everywhere. `revert=True` no-ops
    the gates and the check must catch the poison past each sink."""
    from actor_critic_tpu_torch import weights
    from actor_critic_tpu_torch.algos.traj_queue import PolicyPublisher
    from actor_critic_tpu_torch.parallel.multihost import read_params, write_params
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    dev = _device(device)
    rng = random.Random(seed)
    menu = NONFINITE if revert else (NONFINITE + ("denormal",))
    poison = menu[rng.randrange(len(menu))]
    report = {
        "seed": seed, "scenario": "bf16-update", "poison": poison,
        "trace": [], "rejections": 0, "refusals": 0, "violations": 0,
    }
    fx = _update_fixture(dev, bf16=True)
    block = _synth_block(fx.cfg, np.random.default_rng(seed * 47 + 1))
    loss = float(fx.run(block)["loss"])
    if not math.isfinite(loss):
        report["violations"] += 1
        raise NumSanError(
            f"seed {seed}: the bf16 update produced a non-finite loss "
            f"({loss!r}) on CLEAN data — the float32-accumulator "
            "discipline is missing/reverted"
        )
    good = _numpy(weights.to_flax(fx.net))
    poisoned = _numpy(good)
    path, idx = _poison_tree(poisoned, rng, poison)
    names = list(_flat_dict(good))

    publisher = PolicyPublisher(good, version=1)
    store = PolicyStore()
    store.register("default", _TreeStubEngine(), good, version=1)
    with tempfile.TemporaryDirectory(prefix="numsan_bf16_mbox_") as mailbox, \
            tempfile.TemporaryDirectory(prefix="numsan_bf16_ckpt_") as ckroot:
        write_params(mailbox, 0, 1, _flat_dict(good))
        ckpt = Checkpointer(ckroot, max_to_keep=2)
        ckpt.save(0, _checkpoint_state({"params": good}, dev))

        def attempt(fn, counter):
            try:
                fn()
            except numguard.NonFiniteError:
                report[counter] += 1
                return "rejected"
            return "accepted"

        def restored(step):
            template = _checkpoint_state({"params": good}, dev)
            ckpt.restore(template, step)
            return _numpy(template.device_state)

        sinks = [
            ("publish", lambda: publisher.publish(poisoned, 2), "rejections"),
            ("write_params", lambda: write_params(mailbox, 0, 2, _flat_dict(poisoned)),
             "rejections"),
            ("swap", lambda: store.swap("default", poisoned, version=2), "rejections"),
            ("checkpoint", lambda: ckpt.save(1, _checkpoint_state({"params": poisoned}, dev)),
             "refusals"),
        ]
        if revert:
            with _guards_disabled():
                for name, fn, counter in sinks:
                    report["trace"].append((name, poison, path, idx, attempt(fn, counter)))
            leaked = []
            if numguard.nonfinite_leaves(publisher.get()[1]):
                leaked.append("publisher")
            out = read_params(mailbox, 0, names)
            if out is not None and numguard.nonfinite_leaves(out[1]):
                leaked.append("mailbox")
            if numguard.nonfinite_leaves(dict(store.get("default").params)):
                leaked.append("store")
            if ckpt.latest_step() == 1 and numguard.nonfinite_leaves(restored(1)):
                leaked.append("checkpoint")
            if leaked:
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: REVERTED GUARD DETECTED — "
                    f"{poison} poison at {path}[{idx}] of the bf16 "
                    f"update's params reached {'/'.join(leaked)} "
                    "with check_finite no-op'd (a diverged bf16 "
                    "learner must hit the same wall as the float32 path)"
                )
            return report
        for name, fn, counter in sinks:
            outcome = attempt(fn, counter)
            report["trace"].append((name, poison, path, idx, outcome))
            if poison in NONFINITE and outcome != "rejected":
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: {name} ACCEPTED the bf16 "
                    f"update's {poison}-poisoned params "
                    f"({path}[{idx}]) — the finiteness gate is "
                    "missing/reverted on the bf16 path"
                )
            if poison == "denormal" and outcome != "accepted":
                report["violations"] += 1
                raise NumSanError(
                    f"seed {seed}: {name} rejected a denormal from "
                    "the bf16 update — the gate over-fires"
                )
        if poison in NONFINITE:
            version, pub = publisher.get()
            mbox = read_params(mailbox, 0, names)
            if (
                version != 1 or numguard.nonfinite_leaves(pub)
                or mbox is None or mbox[0] != 1
                or numguard.nonfinite_leaves(mbox[1])
                or store.get("default").version != 1
                or ckpt.latest_step() != 0
            ):
                raise NumSanError(
                    f"seed {seed}: a refusal did not preserve the "
                    "previous good bf16 snapshot"
                )
    return report


# ---------------------------------------------------------------------------
# codec exerciser: saturation, host mirror == device
# ---------------------------------------------------------------------------

_I8_KINDS = ("i8", "i8_unit", "bool8")


def encode_both(kind: str, batch: np.ndarray, np_stats: dict, device: torch.device):
    """(numpy mirror's encoding, the device codec's encoding copied back) of
    one float32 batch under one stats dict."""
    from actor_critic_tpu_torch.data_plane import codecs as np_codecs
    from actor_critic_tpu_torch.replay import quantize

    stats = quantize.QuantStats(
        mean=torch.tensor(np_stats["mean"], device=device),
        scale=torch.tensor(np_stats["scale"], device=device),
        count=torch.tensor(np.int64(np_stats["count"]), device=device),
    )
    host = np_codecs.np_encode(kind, np_stats, batch)
    dev = quantize.encode(kind, stats, torch.from_numpy(batch).to(device),
                          quantize.storage_dtype(kind, torch.float32))
    return host, dev.cpu().numpy()


def exercise_codec(seed: int, revert: bool = False, device="cuda") -> dict:
    """Seeded poisons through the REAL codec pair: the int8 codecs must
    saturate (±127; bool8 {0, 1}) on infinite or saturating magnitudes and
    encode NaN to the midpoint; f16 clips to ±65504 instead of overflowing;
    and the numpy mirror must equal the device codec on `device` bit for
    bit under poison. `revert=True` runs the pre-fix wrapping encoder
    against the check."""
    from actor_critic_tpu_torch.data_plane import codecs as np_codecs

    rng = random.Random(seed)
    # The reverted mode pins the saturating poison: the wrap then shows on
    # every schedule (an inf → int8 cast is platform-defined).
    poison = "saturate" if revert else POISONS[rng.randrange(len(POISONS))]
    report = {
        "seed": seed, "scenario": "codec", "poison": poison,
        "trace": [], "saturations": 0, "violations": 0,
    }
    nprng = np.random.default_rng(seed)
    batch = (nprng.normal(size=(8,)) * 0.3).astype(np.float32)
    idx = rng.randrange(batch.size)
    batch[idx] = _VALUES[poison]
    np_stats = {"mean": np.float32(0.1), "scale": np.float32(2.0), "count": np.int32(4096)}

    if revert:
        # The REVERTED bool8 encoder: round-then-cast WRAPS out-of-range
        # magnitudes instead of saturating.
        q = np.round(batch).astype(np.int8)
        if poison in ("saturate", "inf") and not (0 <= int(q[idx]) <= 1):
            report["violations"] += 1
            raise NumSanError(
                f"seed {seed}: REVERTED CODEC DETECTED — bool8 "
                f"round-then-cast wrapped a {poison} flag to "
                f"{int(q[idx])} (valid range {{0, 1}}); the narrowing "
                "cast must clip first"
            )
        return report

    dev_ = _device(device)
    for kind in _I8_KINDS + ("f16",):
        host, dev = encode_both(kind, batch, np_stats, dev_)
        same = host.dtype == dev.dtype and (
            np.array_equal(host, dev, equal_nan=True)
            if np.issubdtype(host.dtype, np.floating) else np.array_equal(host, dev))
        if not same:
            report["violations"] += 1
            raise NumSanError(
                f"seed {seed}: host/device codec mismatch for {kind} "
                f"under {poison} poison — the mirror contract forked "
                "on garbage input"
            )
        v = host[idx]
        ok = True
        if kind in ("i8", "i8_unit"):
            bound = 127
            if poison == "nan":
                ok = int(v) == 0  # nan_to_num → the midpoint (z = 0 for i8)
            elif poison in ("inf", "saturate"):
                ok = int(v) == bound
                report["saturations"] += ok
            elif poison == "-inf":
                ok = int(v) == -bound
                report["saturations"] += ok
            else:
                ok = -bound <= int(v) <= bound
        elif kind == "bool8":
            if poison in ("inf", "saturate"):
                ok = int(v) == 1
                report["saturations"] += ok
            elif poison in ("nan", "-inf", "denormal"):
                ok = int(v) == 0
            if not (0 <= int(min(host)) and int(max(host)) <= 1):
                ok = False
        else:  # f16
            if poison == "nan":
                ok = bool(np.isnan(v))
            else:
                f16_max = float(np.finfo(np.float16).max)
                ok = bool(np.isfinite(v)) and abs(float(v)) <= f16_max
                if poison in ("inf", "saturate"):
                    report["saturations"] += ok
        if not ok:
            report["violations"] += 1
            raise NumSanError(
                f"seed {seed}: codec {kind} mishandled {poison} at "
                f"[{idx}]: encoded {v!r} — saturation contract "
                "violated (wrap/overflow instead of clip)"
            )
        decoded = np_codecs.np_decode(kind, np_stats, host)
        dec_ok = (bool(np.isnan(decoded[idx])) if (kind == "f16" and poison == "nan")
                  else bool(np.all(np.isfinite(decoded))))
        if not dec_ok:
            report["violations"] += 1
            raise NumSanError(
                f"seed {seed}: codec {kind} decode re-introduced a "
                f"non-finite under {poison}"
            )
        report["trace"].append((kind, poison, idx, repr(v)))
    return report


# ---------------------------------------------------------------------------
# sweep + the quick profile
# ---------------------------------------------------------------------------


def exercise_sweep(seeds: Iterable[int], scenario) -> dict:
    reports = [scenario(seed) for seed in seeds]
    return {
        "schedules": len(reports),
        "divergence_events": sum(r.get("divergence_events", 0) for r in reports),
        "rejections": sum(r.get("rejections", 0) for r in reports),
        "refusals": sum(r.get("refusals", 0) for r in reports),
        "saturations": sum(r.get("saturations", 0) for r in reports),
        "violations": sum(r.get("violations", 0) for r in reports),
    }


def quick_profile(schedules: int = 16, seed0: int = 0, device="cuda") -> dict:
    """The fast profile: `schedules` seeded fault schedules split across the
    five exercisers (JAX's split); every guard class must both FIRE on
    nonfinite poisons and stay QUIET on tolerated ones."""
    n = max(schedules // 5, 1)
    update = exercise_sweep(range(seed0, seed0 + n),
                            lambda s: exercise_update(s, device=device))
    bf16 = exercise_sweep(range(seed0, seed0 + n),
                          lambda s: exercise_bf16_update(s, device=device))
    publish = exercise_sweep(range(seed0, seed0 + n), lambda s: exercise_publish(s))
    checkpoint = exercise_sweep(range(seed0, seed0 + n),
                                lambda s: exercise_checkpoint(s, device=device))
    codec = exercise_sweep(range(seed0, seed0 + (schedules - 4 * n)),
                           lambda s: exercise_codec(s, device=device))
    parts = (update, bf16, publish, checkpoint, codec)
    return {
        "schedules": sum(x["schedules"] for x in parts),
        "update": update,
        "bf16_update": bf16,
        "publish": publish,
        "checkpoint": checkpoint,
        "codec": codec,
        "violations": sum(x["violations"] for x in parts),
    }


def main(argv=None) -> int:
    """The CLI (JAX's `scripts/numsan.py`, with `--device`)."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        prog="python -m actor_critic_tpu_torch.analysis.numsan",
        description="deterministic NaN/Inf/saturation fault sanitizer for the "
        "training-serving stack")
    p.add_argument("--schedules", type=int, default=16,
                   help="seeded fault schedules to sweep (default 16, the quick profile: split "
                   "across update/bf16-update/publish/checkpoint/codec)")
    p.add_argument("--seed0", type=int, default=0,
                   help="first seed of the sweep (a violation names its seed for replay)")
    p.add_argument("--scenario",
                   choices=("all", "update", "bf16-update", "publish", "checkpoint", "codec"),
                   default="all",
                   help="which unit to exercise (default: the quick profile; 'update' drives "
                   "the host PPO update + DivergenceMonitor, 'bf16-update' the bf16_compute "
                   "update against every publish/checkpoint/serve gate, 'publish' the "
                   "PolicyPublisher/mailbox/PolicyStore gates, 'checkpoint' a real commit, "
                   "'codec' the int8/f16 saturation contract)")
    p.add_argument("--revert", action="store_true",
                   help="reverted-guard mode (expected exit 1): no-op the check_finite gates "
                   "(publish/checkpoint/bf16-update) or run the pre-fix wrapping encoder "
                   "(codec) — numsan must detect the leak on every schedule")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the update, checkpoint and codec tensors live (default: the card)")
    args = p.parse_args(argv)

    if args.revert and args.scenario in ("all", "update"):
        print("numsan: error: --revert needs --scenario bf16-update|publish|checkpoint|codec "
              "(the update scenario's guard is the DivergenceMonitor itself)", file=sys.stderr)
        return 2
    dev = args.device
    try:
        if args.scenario == "all":
            out = quick_profile(schedules=args.schedules, seed0=args.seed0, device=dev)
        else:
            scenario = {
                "update": lambda s: exercise_update(s, device=dev),
                "bf16-update": lambda s: exercise_bf16_update(s, revert=args.revert, device=dev),
                "publish": lambda s: exercise_publish(s, revert=args.revert),
                "checkpoint": lambda s: exercise_checkpoint(s, revert=args.revert, device=dev),
                "codec": lambda s: exercise_codec(s, revert=args.revert, device=dev),
            }[args.scenario]
            out = exercise_sweep(range(args.seed0, args.seed0 + args.schedules), scenario)
    except NumSanError as e:
        # A detection names its seed: rerun that seed to replay it.
        print(f"numsan: VIOLATION DETECTED: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"numsan: error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(out, indent=2, default=str))
    else:
        print(f"numsan: {out.get('schedules', 0)} fault schedule(s) clean — every poison "
              "blocked by its named guard")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
