"""The port's numerics sanitizer (`actor_critic_tpu_torch/analysis/numsan.py`)
against the JAX package's (`actor_critic_tpu/analysis/numsan.py`), with the
cases of `tests/test_numsan.py`, on the CPU.

Schedules held to JAX: the poison and leaf draws are Python's
`random.Random` over JAX's leaf enumeration (sorted paths), so for each
seed the port's `report["trace"]` equals JAX's field for field for the
publish, checkpoint, bf16-update (the post-update parameters in flax's
layout, `weights.to_flax`: JAX's leaf paths and shapes) and codec
exercisers. For the update exerciser the round, target, poison kind, flat
index and outcome (divergence or clean) are held; the loss itself is not,
since the port's network is drawn from a torch generator, not JAX's key.

Codecs: the port's device encoder (`replay/quantize.encode`, here on the
CPU) equals JAX's `quantize.encode` and both numpy mirrors bitwise on the
same poisoned inputs (integer codes exactly; f16 bitwise, NaN included).

Revert modes: every one is caught on every schedule, as in JAX's tests,
through the one `numguard.check_finite` seam.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.analysis import numsan as jnumsan
from actor_critic_tpu.data_plane import codecs as jcodecs
from actor_critic_tpu.replay import quantize as jquantize
from actor_critic_tpu_torch.analysis import numsan
from actor_critic_tpu_torch.utils import numguard
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

CPU = {"device": "cpu"}
EXERCISERS = {
    "update": (numsan.exercise_update, CPU),
    "bf16-update": (numsan.exercise_bf16_update, CPU),
    "publish": (numsan.exercise_publish, {}),
    "checkpoint": (numsan.exercise_checkpoint, CPU),
    "codec": (numsan.exercise_codec, CPU),
}
JAX_EXERCISERS = {
    "update": jnumsan.exercise_update,
    "bf16-update": jnumsan.exercise_bf16_update,
    "publish": jnumsan.exercise_publish,
    "checkpoint": jnumsan.exercise_checkpoint,
    "codec": jnumsan.exercise_codec,
}


def _run(name, seed, **kw):
    fn, base = EXERCISERS[name]
    return fn(seed, **base, **kw)


# ---------------------------------------------------------------- held to JAX


@pytest.mark.parametrize("name", sorted(EXERCISERS))
def test_schedule_trace_equals_jax(name):
    for seed in (0, 1, 2, 3, 11):
        ours, theirs = _run(name, seed), JAX_EXERCISERS[name](seed)
        assert ours.get("poison") == theirs.get("poison")
        if name == "update":
            # (round, target, poison, index, outcome); the loss is the port's own.
            held = [t[:4] + t[5:] for t in ours["trace"]]
            assert held == [t[:4] + t[5:] for t in theirs["trace"]]
        else:
            assert ours["trace"] == theirs["trace"]
        for k in ("divergence_events", "rejections", "refusals", "saturations", "violations"):
            assert ours.get(k) == theirs.get(k), k


def test_quick_profile_sweeps_clean_and_counts_as_jax():
    out = numsan.quick_profile(schedules=10, seed0=0, device="cpu")
    assert out == jnumsan.quick_profile(schedules=10, seed0=0)
    assert out["violations"] == 0 and out["schedules"] == 10
    fired = (out["publish"]["rejections"] + out["checkpoint"]["refusals"]
             + out["bf16_update"]["rejections"] + out["bf16_update"]["refusals"])
    assert fired > 0


@pytest.mark.parametrize("seed", range(6))
def test_codec_outputs_equal_jax_encoders_bitwise(seed):
    rng = random.Random(seed)
    poison = numsan.POISONS[rng.randrange(len(numsan.POISONS))]
    batch = (np.random.default_rng(seed).normal(size=(8,)) * 0.3).astype(np.float32)
    batch[rng.randrange(batch.size)] = numsan._VALUES[poison]
    np_stats = {"mean": np.float32(0.1), "scale": np.float32(2.0), "count": np.int32(4096)}
    jstats = jquantize.QuantStats(mean=jnp.asarray(np_stats["mean"]),
                                  scale=jnp.asarray(np_stats["scale"]),
                                  count=jnp.asarray(np_stats["count"]))
    for kind in ("i8", "i8_unit", "bool8", "f16"):
        host, dev = numsan.encode_both(kind, batch, np_stats, torch.device("cpu"))
        jdev = np.asarray(jquantize.encode(kind, jstats, jnp.asarray(batch),
                                           jquantize.storage_dtype(kind, jnp.float32)))
        jhost = jcodecs.np_encode(kind, np_stats, batch)
        for other in (dev, jdev, jhost):
            assert host.dtype == other.dtype and host.tobytes() == other.tobytes(), kind


# ------------------------------------------------------------------ clean sweeps


def test_update_poisons_fire_divergence_monitor():
    out = numsan.exercise_sweep(range(6), lambda s: numsan.exercise_update(s, device="cpu"))
    assert out["violations"] == 0 and out["divergence_events"] > 0


def test_bf16_update_poisons_refused_at_every_sink():
    out = numsan.exercise_sweep(range(4), lambda s: numsan.exercise_bf16_update(s, device="cpu"))
    assert out["violations"] == 0 and out["rejections"] + out["refusals"] > 0


def test_codec_saturations_observed():
    out = numsan.exercise_sweep(range(8), lambda s: numsan.exercise_codec(s, device="cpu"))
    assert out["violations"] == 0 and out["saturations"] > 0


@pytest.mark.parametrize("name", sorted(EXERCISERS))
def test_replay_is_bit_identical_per_seed(name):
    a, b = _run(name, 11), _run(name, 11)
    assert a["trace"] == b["trace"]
    different = _run(name, 12)
    assert different["trace"] != a["trace"] or different.get("poison") != a.get("poison")


def test_update_leaves_its_fixture_as_it_found_it():
    """The port's update writes the network in place; every schedule starts
    from the same parameters (JAX's update is functional)."""
    a = numsan.exercise_update(3, device="cpu")
    numsan.exercise_update(11, device="cpu")  # a nan round in between
    assert numsan.exercise_update(3, device="cpu")["trace"] == a["trace"]


# ------------------------------------------------- reverted modes: always caught


@pytest.mark.parametrize("name", ["publish", "checkpoint", "bf16-update"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverted_guard_detected(name, seed):
    with pytest.raises(numsan.NumSanError, match="REVERTED GUARD"):
        _run(name, seed, revert=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverted_codec_wrap_detected(seed):
    with pytest.raises(numsan.NumSanError, match="REVERTED CODEC"):
        numsan.exercise_codec(seed, revert=True, device="cpu")


def test_revert_mode_restores_the_guard():
    orig = numguard.check_finite
    with pytest.raises(numsan.NumSanError):
        numsan.exercise_publish(0, revert=True)
    assert numguard.check_finite is orig
    with pytest.raises(numguard.NonFiniteError):
        numguard.check_finite({"w": np.array([np.nan], np.float32)}, "post-revert")


def test_denormal_poisons_are_tolerated():
    hits = 0
    for seed in range(40):
        if random.Random(seed).randrange(4) == 3:  # the denormal slot
            out = numsan.exercise_publish(seed)
            assert out["poison"] == "denormal"
            assert out["rejections"] == 0 and out["violations"] == 0
            hits += 1
            if hits >= 2:
                break
    assert hits >= 1


# -------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("argv,rc", [
    (["--scenario", "codec", "--schedules", "4"], 0),
    (["--scenario", "codec", "--revert", "--schedules", "2"], 1),
    (["--scenario", "publish", "--revert", "--schedules", "2"], 1),
    (["--scenario", "checkpoint", "--revert", "--schedules", "2"], 1),
    (["--scenario", "bf16-update", "--revert", "--schedules", "2"], 1),
    (["--revert"], 2),
    (["--schedules", "6"], 0),
], ids=["codec", "codec-revert", "publish-revert", "checkpoint-revert", "bf16-revert",
        "revert-without-scenario", "quick"])
def test_cli_exit_codes(argv, rc, capsys):
    assert numsan.main(argv + ["--device", "cpu"]) == rc
    capsys.readouterr()


def test_cli_json_mode(capsys):
    import json

    assert numsan.main(["--scenario", "publish", "--schedules", "3", "--json",
                        "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["schedules"] == 3 and payload["violations"] == 0
