"""The port's chaos sanitizer (`actor_critic_tpu_torch/analysis/fleetsan.py`)
against the JAX package's (`actor_critic_tpu/analysis/fleetsan.py`), with the
cases of `tests/test_fleetsan.py`, on the CPU.

Held to JAX, seed for seed, exactly: every field of the fleet, gateway and
replica reports (the trace, takes, deposits, swaps, kills, faults, recover
rounds and violations). The schedule is decided by Python's
`random.Random(seed)` and by the mailbox files' sizes, and the two packages
write the same `.npz` (`leaf<i>` and `version`), so nothing in a report can
differ. The reverted modes are caught as JAX's are: the shared-tmp collision
on the same first seed with the same message.

One real-process `run_process_chaos` runs here at world 2 on the CPU (the
sleep-padded CartPole workers, a 6 s window) with its own timeouts: the
SIGKILLed rank recovers and its flight ring is harvested into a dump.
"""

import importlib.util
import os

import pytest

from actor_critic_tpu.analysis import fleetsan as jfleetsan
from actor_critic_tpu_torch.analysis import fleetsan
from actor_critic_tpu_torch.analysis.fleetsan import FleetSanError
from torch_threads import one_intra_op_thread  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = ("exercise_fleet", "exercise_gateway", "exercise_replica_fleet")


# ---------------------------------------------------------------- held to JAX


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_report_equals_jax(scenario, seed):
    ours = getattr(fleetsan, scenario)(seed)
    theirs = getattr(jfleetsan, scenario)(seed)
    assert ours == theirs
    assert ours["violations"] == 0 and ours["trace_len"] > 0


@pytest.mark.parametrize("kw", [dict(world=4, rounds=6), dict(world=2, rounds=12),
                                dict(faults=False)])
def test_fleet_report_equals_jax_off_default(kw):
    for seed in (3, 9):
        assert fleetsan.exercise_fleet(seed, **kw) == jfleetsan.exercise_fleet(seed, **kw)


def test_replica_report_equals_jax_at_other_sizes():
    for seed in (1, 4):
        kw = dict(versions=6, replicas=2)
        assert (fleetsan.exercise_replica_fleet(seed, **kw)
                == jfleetsan.exercise_replica_fleet(seed, **kw))


def test_quick_profile_sweeps_clean_and_equals_jax():
    out = fleetsan.quick_profile(schedules=12, seed0=0)
    assert out == jfleetsan.quick_profile(schedules=12, seed0=0)
    assert out["violations"] == 0 and out["schedules"] == 12
    assert out["fleet"]["takes"] > 0 and out["fleet"]["kills"] > 0
    assert out["gateway"]["swaps"] > 0


# ------------------------------------------------------------- own contract


def test_seeded_schedules_replay_bit_identically():
    for scenario in SCENARIOS:
        a, b = (getattr(fleetsan, scenario)(7) for _ in range(2))
        assert a == b


def test_different_seeds_permute_schedules_and_faults():
    reports = [fleetsan.exercise_fleet(seed, rounds=5) for seed in range(8)]
    assert len({tuple(r["trace"]) for r in reports}) > 1
    assert len({tuple(r["faults"]) for r in reports}) > 1


def test_every_kill_recovers_within_the_bound():
    kills = 0
    for seed in range(6):
        r = fleetsan.exercise_fleet(seed, rounds=8)
        assert len(r["recover_rounds"]) == r["kills"]
        assert all(0 <= x <= 12 for x in r["recover_rounds"])
        kills += r["kills"]
    assert kills > 0


def test_replica_kill_mid_swap_sweeps_clean():
    kills = 0
    for seed in range(6):
        r = fleetsan.exercise_replica_fleet(seed, versions=6, replicas=3)
        assert r["violations"] == 0 and r["swaps"] > 0 and r["published"] == 6
        kills += r["kills"]
    assert kills > 0


# ------------------------------------------------------------ reverted modes


def test_direct_writer_caught_on_every_schedule():
    for seed in range(6):
        with pytest.raises(FleetSanError, match="unreadable|corrupt"):
            fleetsan.exercise_fleet(seed, world=3, rounds=6, writer="direct", faults=False)


def _first_collision(module):
    for seed in range(16):
        try:
            module.exercise_fleet(seed, world=3, rounds=8, writer="shared_tmp", faults=False)
        except module.FleetSanError as e:
            return seed, str(e)
    return None, None


def test_shared_tmp_caught_within_jax_seeds_and_replays():
    seed, msg = _first_collision(fleetsan)
    assert seed is not None, "16 seeds never collided the shared tempfile"
    assert (seed, msg) == _first_collision(jfleetsan)
    with pytest.raises(FleetSanError) as again:
        fleetsan.exercise_fleet(seed, world=3, rounds=8, writer="shared_tmp", faults=False)
    assert str(again.value) == msg


def test_naive_poller_regresses_on_every_schedule():
    for seed in range(6):
        with pytest.raises(FleetSanError, match="regress|swapped BACK"):
            fleetsan.exercise_gateway(seed, poller="naive")


def test_unknown_modes_are_errors_not_detections():
    with pytest.raises(ValueError):
        fleetsan.exercise_gateway(0, poller="sloppy")
    with pytest.raises(ValueError):
        fleetsan.exercise_fleet(0, writer="sloppy")


# ------------------------------------------------------------------ the CLI


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "fleetsan_cli", os.path.join(REPO, "scripts", "fleetsan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv,code", [
    (["--schedules", "4"], 0),
    (["--scenario", "replica", "--schedules", "2"], 0),
    (["--scenario", "fleet", "--writer", "direct", "--schedules", "2"], 1),
    (["--scenario", "gateway", "--poller", "naive", "--schedules", "2"], 1),
    (["--scenario", "fleet", "--world", "1", "--schedules", "1"], 2),
])
def test_cli_exit_codes_equal_jax(argv, code, capsys):
    assert fleetsan.main(argv + ["--device", "cpu"]) == code
    ours = capsys.readouterr()
    assert _jax_cli().main(argv) == code
    theirs = capsys.readouterr()
    if code == 0:
        assert ours.out == theirs.out
    else:
        assert ours.err.split(":")[:2] == theirs.err.split(":")[:2]


def test_cli_json(capsys):
    import json

    assert fleetsan.main(["--schedules", "4", "--json", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == jfleetsan.quick_profile(schedules=4)


# --------------------------------------------------- the real-process injector


def test_process_chaos_recovers_and_leaves_a_flight_dump(tmp_path):
    from actor_critic_tpu_torch.telemetry import flight

    rec = fleetsan.run_process_chaos(world=2, duration_s=6.0, kill_after_s=2.5,
                                     timeout_s=90.0, telemetry_dir=str(tmp_path), device="cpu")
    assert rec["ok"], rec
    assert rec["time_to_recover_s"] > 0
    assert rec["survivor_gossip_mixes"] > 0 and rec["restarted_consumed_blocks"] > 0
    assert rec["flight_records"] > 0
    dumps = flight.find_dumps(tmp_path / "host1")
    assert dumps == [rec["flight_dump"]]
    assert rec["launches"] == {}  # the CPU counts no kernel launches
