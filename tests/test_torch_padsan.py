"""The port's padding sanitizer (`actor_critic_tpu_torch/analysis/padsan.py`)
against the JAX package's (`actor_critic_tpu/analysis/padsan.py`), with the
cases of `tests/test_padsan.py`, on the CPU.

Schedules held to JAX: the draws are Python's `random.Random`, so for each
seed the port's `report["trace"]` equals JAX's in every schedule field —
the round, the op and E (pallas), the live member's name (mixture), n
(serving), the codec and the leased slot (device-plane), and the poison.
Not held: the output digests at the end of each trace entry (the port's
kernel scenario runs T = 100 where JAX's runs T = 4, its networks and env
draws come from torch generators, and its int8 decode may differ from
XLA's by one ulp), nor `report["digest"]`, a hash over them.

JAX's `chunked` scenario has no counterpart seam in the port; the CLI
refuses it (exit 2) with a message that says why.

On the CPU the kernel scenario runs the kernels' plain versions through
the same wrappers (`out=` into the tailed allocations); on the card it
launches the kernels (`chip_smoke.py` counts the launches).
"""

import numpy as np
import pytest

from actor_critic_tpu.analysis import padsan as jpadsan
from actor_critic_tpu_torch.analysis import padsan
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

SCENARIOS = sorted(padsan.EXERCISERS)
JAX_EXERCISERS = {
    "pallas": jpadsan.exercise_pallas,
    "mixture": jpadsan.exercise_mixture,
    "serving": jpadsan.exercise_serving,
    "device-plane": jpadsan.exercise_device_plane,
}


def _run(scenario, seed, **kw):
    return padsan.EXERCISERS[scenario](seed, device="cpu", **kw)


# ---------------------------------------------------------------- held to JAX


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_schedule_fields_equal_jax(scenario):
    for seed in (0, 1, 5, 11):
        ours, theirs = _run(scenario, seed), JAX_EXERCISERS[scenario](seed)
        assert [t[:-1] for t in ours["trace"]] == [t[:-1] for t in theirs["trace"]]
        assert ours["programs"] == theirs["programs"]
        assert ours["violations"] == theirs["violations"] == 0


def test_cli_refuses_chunked_and_says_why(capsys):
    assert padsan.main(["--scenario", "chunked", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "no counterpart seam in the port" in err and "n_valid" in err


# ------------------------------------------------ clean sweeps: pads unobservable


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_sweeps_clean(scenario):
    out = padsan.exercise_sweep(range(3), lambda s: _run(scenario, s))
    assert out["violations"] == 0 and out["schedules"] == 3
    assert out["programs"] == 3 * 2 * 2


def test_quick_profile_sweeps_clean():
    out = padsan.quick_profile(schedules=10, seed0=0, device="cpu")
    assert out["violations"] == 0 and out["schedules"] == 10
    for key in ("pallas", "mixture", "serving", "device_plane"):
        assert out[key]["schedules"] >= 2 and out[key]["violations"] == 0


def test_kernel_scenario_covers_every_ragged_width():
    seen = set()
    for seed in range(8):
        seen.update(t[2] for t in _run("pallas", seed)["trace"])
    assert seen == set(padsan.KERNEL_ES)


@pytest.mark.parametrize("op", padsan.KERNEL_OPS)
@pytest.mark.parametrize("E", padsan.KERNEL_ES)
def test_kernel_call_fills_only_the_plane(op, E):
    """The wrappers' `out=` writes exactly the [T, E] view: the tails keep
    their fill, and the outputs equal the ops' own (allocating) results."""
    import torch

    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    ins = padsan._kernel_inputs(op, E, np.random.default_rng(E))
    outs, flats = padsan.kernel_call(op, ins, float("nan"), torch.device("cpu"))
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    if op == "vtrace":
        ref = vtrace_cuda.vtrace(t["target_log_probs"], t["behaviour_log_probs"], t["rewards"],
                                 t["values"], t["dones"], t["bootstrap_value"], 0.99)
    else:
        ref = gae_cuda.gae(t["rewards"], t["values"], t["dones"], t["bootstrap_value"],
                           0.99, 0.95)
        ref = ref if op == "gae" else ref[1:]
    for got, want in zip(outs, ref):
        assert got.tobytes() == want.numpy().tobytes()
    n = padsan.KERNEL_T * E
    for flat in flats:
        assert np.isnan(flat[n:]).all() and not np.isnan(flat[:n]).any()


# ------------------------------------------------------- bit-identical replay


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_replay_is_bit_identical_per_seed(scenario):
    a, b = _run(scenario, 11), _run(scenario, 11)
    assert a["digest"] == b["digest"] and a["trace"] == b["trace"]
    assert _run(scenario, 12)["digest"] != a["digest"]


# ------------------------------------------- reverted modes: caught every time


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverted_unmasked_mean_detected(scenario, seed):
    with pytest.raises(padsan.PadSanError, match="REVERTED GUARD"):
        _run(scenario, seed, revert="unmasked-mean")


@pytest.mark.parametrize("scenario", ["pallas", "serving"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverted_no_slice_detected(scenario, seed):
    with pytest.raises(padsan.PadSanError, match="REVERTED GUARD"):
        _run(scenario, seed, revert="no-slice")


@pytest.mark.parametrize("scenario", ["mixture", "device-plane"])
def test_no_slice_is_rejected_where_it_means_nothing(scenario):
    with pytest.raises(ValueError, match="supports revert modes"):
        _run(scenario, 0, revert="no-slice")


def test_revert_mode_restores_the_seam():
    from actor_critic_tpu_torch.serving import engine

    orig = engine.pad_to_bucket
    with pytest.raises(padsan.PadSanError):
        padsan.exercise_serving(0, revert="unmasked-mean", device="cpu")
    assert engine.pad_to_bucket is orig


# ------------------------------------------------------ the masked-summary seam


def test_masked_summary_equals_jax_and_excludes_pad_lanes():
    x = np.array([1.0, 2.0, np.nan, np.inf], np.float64)
    mask = np.array([1.0, 1.0, 0.0, 0.0])
    a = padsan.masked_summary(x, mask)
    assert a == padsan.masked_summary(np.array([1.0, 2.0, 0.0, 0.0]), mask)
    assert padsan.masked_summary(x, mask, revert="unmasked-mean") != a
    for revert in (None, "unmasked-mean"):
        assert padsan.masked_summary(x, mask, revert) == jpadsan.masked_summary(x, mask, revert)


def test_fill_is_dtype_aware_as_jax():
    import torch

    for poison in padsan.POISONS:
        for dt in (np.float32, np.int8, np.int32):
            ours, theirs = padsan._fill(poison, dt), jpadsan._fill(poison, dt)
            assert np.float64(ours).tobytes() == np.float64(theirs).tobytes()
    assert padsan._fill("-big", torch.int8) == -128.0
    assert padsan._fill("big", torch.int8) == 127.0


# -------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("argv,rc", [
    (["--scenario", "mixture", "--schedules", "2"], 0),
    (["--scenario", "mixture", "--revert", "unmasked-mean", "--schedules", "1"], 1),
    (["--scenario", "serving", "--revert", "no-slice", "--schedules", "1"], 1),
    (["--scenario", "pallas", "--revert", "no-slice", "--schedules", "1"], 1),
    (["--revert", "unmasked-mean"], 2),
    (["--scenario", "mixture", "--revert", "no-slice"], 2),
    (["--quick", "--schedules", "4"], 0),
], ids=["clean", "unmasked", "serving-no-slice", "pallas-no-slice", "revert-alone",
        "no-slice-on-mixture", "quick"])
def test_cli_exit_codes(argv, rc, capsys):
    assert padsan.main(argv + ["--device", "cpu"]) == rc
    capsys.readouterr()


def test_cli_json_mode(capsys):
    import json

    assert padsan.main(["--scenario", "device-plane", "--schedules", "2", "--json",
                        "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["schedules"] == 2 and out["violations"] == 0


def test_chunked_stays_jax_only():
    """The refusal is the port's alone: JAX's padsan keeps `chunked`."""
    assert "chunked" in jpadsan.SCENARIO_REVERTS and "chunked" not in padsan.SCENARIO_REVERTS
