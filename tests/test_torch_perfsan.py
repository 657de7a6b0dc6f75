"""The port's budget sanitizer (`actor_critic_tpu_torch/analysis/perfsan.py`)
on the CPU.

JAX's meter counts XLA executions at its jit `post_hook`, which it reaches
through `jaxlib.xla_extension`; where that does not import it cannot count
at all, so the port is held to JAX's CONTRACT, not its numbers: the same program names and budget keys, a
manifest JAX's own `load_manifest` accepts, JAX's refusals of malformed
manifests (exit 2), every program within its budget with counters identical
run to run, each reverted mode caught on every run on JAX's key
(host-gather: transfers, unfused: dispatches, uncommit: recompiles), and a
`measure()` that leaves nothing patched. The numbers gated here are the
manifest's `cpu` values; `chip_smoke.py` gates the `cuda` ones on the card.

The crossing classifier is held without a card: `meta` tensors stand in for
the card's (a copy between `cpu` and `meta` is a crossing, as one between
`cpu` and `cuda` is).
"""

import json
import threading

import pytest
import torch

from actor_critic_tpu.analysis import perfsan as jperfsan
from actor_critic_tpu_torch.analysis import perfsan
from actor_critic_tpu_torch.analysis.perfsan import ManifestError, PerfSanError
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

MANIFEST = perfsan.default_manifest_path()


def _budgets():
    return perfsan.load_manifest(MANIFEST, "cpu")


def _write(tmp_path, programs, name="m.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"version": 1, "programs": programs}))
    return str(p)


BASE = {"max_dispatches_per_block": 1, "max_transfers_per_block": 1,
        "max_transferred_bytes_per_block": 4, "max_recompiles": 0}


# ------------------------------------------------------------ JAX's contract


def test_programs_and_budget_keys_equal_jax():
    assert perfsan.PROGRAMS == jperfsan.PROGRAMS
    assert perfsan.BUDGET_KEYS == jperfsan.BUDGET_KEYS
    assert set(perfsan.EXERCISERS) == set(perfsan.PROGRAMS)


@pytest.mark.parametrize("platform", [None, "cpu", "cuda"])
def test_manifest_has_every_program_and_key(platform):
    budgets = perfsan.load_manifest(MANIFEST, platform)
    for name in (*perfsan.PROGRAMS, "ppo_update_device.enqueue"):
        assert set(perfsan.BUDGET_KEYS) <= set(budgets[name]), name
        for key in perfsan.BUDGET_KEYS:
            value = budgets[name][key]
            if platform is None and isinstance(value, dict):
                assert sorted(value) == ["cpu", "cuda"]
            else:
                assert isinstance(value, int) and value >= 0


def test_manifest_passes_jax_load_manifest():
    ours = jperfsan.load_manifest(MANIFEST)
    assert set(ours) == set(perfsan.load_manifest(MANIFEST, None))
    assert perfsan.default_manifest_path() != jperfsan.default_manifest_path()


def test_manifest_counts_the_serving_and_mixture_contracts():
    for platform in ("cpu", "cuda"):
        b = perfsan.load_manifest(MANIFEST, platform)
        assert all(v == 0 for k, v in b["serving_proxy_hop"].items() if k != "transfer_guard")
        assert b["mixture_fleet_step"]["max_dispatches_per_block"] == 1
        assert b["mixture_fleet_step"]["max_transfers_per_block"] == 0
        for name in perfsan.PROGRAMS:
            assert b[name]["max_recompiles"] == 0


def test_malformed_manifest_is_a_crash_not_a_detection(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    for path in (str(p), str(tmp_path / "missing.json")):
        with pytest.raises(ManifestError):
            perfsan.load_manifest(path)
    p.write_text(json.dumps({"version": 1, "programs": []}))
    with pytest.raises(ManifestError, match="expected"):
        perfsan.load_manifest(str(p))
    with pytest.raises(ManifestError, match="must be an object"):
        perfsan.load_manifest(_write(tmp_path, {"x": 3}))


def test_manifest_key_typos_are_refused(tmp_path):
    typo = dict(BASE)
    typo["max_transfer_per_block"] = typo.pop("max_transfers_per_block")
    with pytest.raises(ManifestError, match="unknown key"):
        perfsan.load_manifest(_write(tmp_path, {"x": typo}))
    dropped = dict(BASE)
    del dropped["max_recompiles"]
    with pytest.raises(ManifestError, match="missing budget"):
        perfsan.load_manifest(_write(tmp_path, {"x": dropped}))
    # JAX refuses both the same way
    for bad in (typo, dropped):
        with pytest.raises(jperfsan.ManifestError):
            jperfsan.load_manifest(_write(tmp_path, {"x": bad}, "j.json"))


@pytest.mark.parametrize("value", [-1, 1.5, True, "2", {"cpu": 1}, {"cpu": 1, "gpu": 2},
                                   {"cpu": 1, "cuda": -3}])
def test_manifest_budget_values_are_checked(tmp_path, value):
    with pytest.raises(ManifestError):
        perfsan.load_manifest(_write(tmp_path, {"x": dict(BASE, max_recompiles=value)}))


def test_manifest_refuses_unknown_guard_and_platform(tmp_path):
    with pytest.raises(ManifestError, match="transfer_guard"):
        perfsan.load_manifest(_write(tmp_path, {"x": dict(BASE, transfer_guard="sometimes")}))
    with pytest.raises(ManifestError, match="platform"):
        perfsan.load_manifest(MANIFEST, "tpu")


def test_per_platform_values_resolve(tmp_path):
    path = _write(tmp_path, {"x": dict(BASE, max_dispatches_per_block={"cpu": 10, "cuda": 1})})
    assert perfsan.load_manifest(path, "cpu")["x"]["max_dispatches_per_block"] == 10
    assert perfsan.load_manifest(path, "cuda")["x"]["max_dispatches_per_block"] == 1


# --------------------------------------------------- the programs, on the CPU


@pytest.mark.parametrize("name", perfsan.PROGRAMS)
def test_program_within_its_cpu_budget(name):
    report = perfsan.run_program(name, _budgets(), device="cpu")
    c = report["counters"]
    assert c.recompiles == 0
    budget = _budgets()[name]
    # pinned exactly: the budget is the measured actual
    assert c.dispatches == budget["max_dispatches_per_block"]
    assert c.transfers == budget["max_transfers_per_block"]
    assert c.transferred_bytes == budget["max_transferred_bytes_per_block"]


def test_device_plane_moves_no_block_and_prices_the_enqueue():
    report = perfsan.run_program("ppo_update_device", _budgets(), device="cpu")
    c = report["counters"]
    assert c.transfers == 0 and c.dispatch_names == {"aten.fill_.Scalar": 1,
                                                     "ppo.async_update": 1}
    # the actor pays its encoded bytes instead, fewer than the raw block's
    assert report["enqueue"].transferred_bytes >= report["enqueue_bytes_per_block"]
    assert report["enqueue_bytes_per_block"] < report["host_bytes_per_block"]


def test_serving_swap_copies_parameters_without_recompiling():
    report = perfsan.run_program("serving_dispatch", _budgets(), device="cpu")
    before, after = report["per_act"][:-1], report["per_act"][-1]
    assert all(c.dispatches == 1 and c.transfers == 2 for c in before)
    assert after.dispatch_names["aten.copy_.default"] == 6 and after.recompiles == 0


def test_serving_overlap_is_metered_on_the_flight_thread():
    report = perfsan.run_program("serving_overlap", _budgets(), device="cpu")
    assert all(c.dispatch_names == {"serving.act[b=1]": 1} for c in report["per_act"])


@pytest.mark.parametrize("name", ["ppo_update_device", "serving_dispatch", "mixture_fleet_step"])
def test_counters_are_identical_run_to_run_and_across_seeds(name):
    fn = perfsan.EXERCISERS[name]
    a, b, c = fn(device="cpu"), fn(device="cpu"), fn(seed=7, device="cpu")
    key = next(k for k in ("per_block", "per_act", "per_call") if k in a)
    assert [x.as_dict() for x in a[key]] == [x.as_dict() for x in b[key]]
    assert a["counters"].as_dict() == c["counters"].as_dict()


def test_quick_profile_green_on_the_cpu():
    out = perfsan.quick_profile(device="cpu",
                                programs=("ppo_update_fused", "serving_proxy_hop"))
    assert out["platform"] == "cpu" and out["violations"] == 0
    assert set(out["programs"]) == {"ppo_update_fused", "serving_proxy_hop"}
    assert "launches" not in out["programs"]["ppo_update_fused"]  # counted on the card only


# ---------------------------------------------------- the meter is not vacuous


def test_tightened_budget_is_a_violation():
    tight = {"ppo_update_host": dict(BASE, max_dispatches_per_block=0,
                                     max_transfers_per_block=0,
                                     max_transferred_bytes_per_block=0)}
    with pytest.raises(PerfSanError, match="BUDGET VIOLATION"):
        perfsan.run_program("ppo_update_host", tight, device="cpu")


def test_missing_program_budget_is_a_violation():
    with pytest.raises(PerfSanError, match="no budget entry"):
        perfsan.check_budget("brand_new_program", perfsan.Counters(), {})


@pytest.mark.parametrize("run", [0, 1])
@pytest.mark.parametrize("mode,key", [("host-gather", "max_transfers_per_block"),
                                      ("unfused", "max_dispatches_per_block"),
                                      ("uncommit", "max_recompiles")])
def test_reverted_mode_caught_on_its_key(mode, key, run):
    with pytest.raises(PerfSanError, match=key):
        perfsan.run_reverted(mode, MANIFEST, device="cpu")


def test_unknown_revert_is_refused():
    with pytest.raises(PerfSanError, match="unknown reverted mode"):
        perfsan.run_reverted("sloppy", MANIFEST, device="cpu")


# --------------------------------------------------------------- the meter


def test_measure_restores_every_seam():
    from actor_critic_tpu_torch.algos import host_loop, loop
    from actor_critic_tpu_torch.serving import engine

    before = perfsan.seam_originals()
    named = (torch.cuda.CUDAGraph.replay, loop.CapturedStep.replay, host_loop.HostUpdate.__call__,
             engine._Lane._forward, engine._Lane.run, torch.Tensor.numpy, torch.from_numpy)
    for guard in (None, "disallow"):
        with pytest.raises(RuntimeError, match="boom"):
            with perfsan.measure(guard=guard, device="cpu"):
                assert perfsan.seam_originals() != before  # patched inside
                raise RuntimeError("boom")
        assert perfsan.seam_originals() == before
    assert (torch.cuda.CUDAGraph.replay, loop.CapturedStep.replay, host_loop.HostUpdate.__call__,
            engine._Lane._forward, engine._Lane.run, torch.Tensor.numpy,
            torch.from_numpy) == named
    assert "numpy" not in vars(torch.Tensor)
    assert torch.utils._python_dispatch._get_current_dispatch_mode_stack() == []


def test_measure_is_not_reentrant():
    with perfsan.measure(device="cpu"):
        with pytest.raises(RuntimeError, match="reentrant"):
            with perfsan.measure(device="cpu"):
                pass
    with perfsan.measure(device="cpu"):  # and usable again after
        pass


def test_crossings_between_cpu_and_meta():
    with perfsan.measure(device="meta") as c:
        dev = torch.empty(4, device="meta")
        dev.copy_(torch.ones(4))  # in: 16 B
        with pytest.raises(NotImplementedError):  # meta holds no data: counted, then refused
            dev.to("cpu")  # out: 16 B (_to_copy)
        dev.add_(1)  # a device op
        torch.zeros(8, device="meta")  # a factory: its fill
        dev[1:3].view(2, 1)  # views: nothing
    assert c.transfers == 2 and c.transferred_bytes == 32
    assert c.dispatches == 2 and set(c.dispatch_names) == {"aten.add_.Tensor",
                                                           "aten.zeros.default"}


def test_guard_allows_explicit_staging_and_raises_on_implicit_crossings():
    with perfsan.measure(guard="disallow", device="meta") as c:
        torch.empty(4, device="meta").copy_(torch.ones(4), non_blocking=True)
        torch.ones(4).to("meta", non_blocking=True)
    assert c.transfers == 2
    for implicit in (lambda: torch.empty(4, device="meta").copy_(torch.ones(4)),
                     lambda: torch.ones(4).to("meta"),
                     lambda: torch.empty(4, device="meta").add_(torch.ones(()))):
        with pytest.raises(PerfSanError, match="TRANSFER GUARD"):
            with perfsan.measure(guard="disallow", device="meta"):
                implicit()
    with pytest.raises(PerfSanError, match="scalar read"):
        with perfsan.measure(guard="disallow", device="cpu"):
            torch.ones(3).sum().item()


def test_cpu_numpy_hand_offs_are_the_crossings():
    import numpy as np

    a = np.zeros((2, 3), np.float32)
    with perfsan.measure(device="cpu") as c:
        t = torch.from_numpy(a)  # 24 B in
        t.numpy()  # 24 B out
        torch.ones(2).tolist()  # 8 B out (and the factory's fill: a device op)
        t.add_(1)  # a device op on the CPU
    assert (c.transfers, c.transferred_bytes, c.dispatches) == (3, 56, 2)
    with perfsan.measure(device="meta") as c:
        torch.from_numpy(a)  # a host tensor where the device is another
    assert c.transfers == 0


def test_program_seams_count_once_and_hide_their_body():
    from actor_critic_tpu_torch.algos import host_loop

    x = torch.zeros(3)
    update = host_loop.HostUpdate(lambda: {"y": x.add_(1).mul_(2)}, torch.Generator(),
                                  name="toy", carried=lambda: {"x": x})
    with perfsan.measure(device="cpu") as c:
        update()
        update()
        x.add_(1)  # outside a seam
    assert c.dispatch_names == {"toy": 2, "aten.add_.Tensor": 1}
    # the CPU's capture stand-in: the first metered call, and a call on
    # other tensors than the first's
    assert c.recompiles == 1
    with perfsan.measure(device="cpu") as c:
        update()
    assert c.recompiles == 0
    x = torch.zeros(3)  # the program now reads other addresses
    with perfsan.measure(device="cpu") as c:
        update()
    assert c.recompiles == 1


def test_kernel_launches_outside_seams_are_dispatches(monkeypatch):
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    calls = []
    monkeypatch.setattr(gae_cuda, "_bind", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(vtrace_cuda, "_bind", lambda: lambda *a: calls.append(a) or 0)
    with perfsan.measure(device="cpu") as c:
        gae_cuda._bind()(1, 2)
        vtrace_cuda._bind()(3)
    assert calls == [(1, 2), (3,)]
    assert c.dispatch_names == {"gae kernel": 1, "vtrace kernel": 1}


def test_threads_are_metered_only_through_a_seam():
    out = []
    with perfsan.measure(device="cpu") as c:
        t = threading.Thread(target=lambda: out.append(torch.ones(2).add_(1)))
        t.start()
        t.join()
    assert c.dispatches == 0  # another thread's eager op, outside any seam


# ------------------------------------------------------------------ the CLI


def test_cli_exit_codes(capsys, tmp_path):
    assert perfsan.main(["--program", "serving_proxy_hop", "--device", "cpu"]) == 0
    assert "green" in capsys.readouterr().out
    tight = _write(tmp_path, {"serving_dispatch": dict(BASE, max_dispatches_per_block=0,
                                                       max_transfers_per_block=0,
                                                       max_transferred_bytes_per_block=0)})
    assert perfsan.main(["--program", "serving_dispatch", "--manifest", tight,
                         "--device", "cpu"]) == 1
    assert "VIOLATION DETECTED" in capsys.readouterr().err
    assert perfsan.main(["--program", "serving_dispatch", "--manifest",
                         str(tmp_path / "missing.json"), "--device", "cpu"]) == 2
    assert perfsan.main(["--program", "no-such", "--device", "cpu"]) == 2
    assert perfsan.main(["--revert", "uncommit", "--program", "serving_dispatch",
                         "--device", "cpu"]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("mode", perfsan.REVERTS)
def test_cli_revert_modes_exit_one(mode, capsys):
    assert perfsan.main(["--revert", mode, "--device", "cpu"]) == 1
    assert "VIOLATION DETECTED" in capsys.readouterr().err


def test_cli_quick_json_and_out(capsys, tmp_path):
    out_path = tmp_path / "actuals.json"
    assert perfsan.main(["--quick", "--json", "--out", str(out_path), "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert set(payload["programs"]) == set(perfsan.PROGRAMS)
    assert payload["programs"]["serving_dispatch"]["actuals"]["recompiles"] == 0
    assert json.loads(out_path.read_text()) == payload
