"""The port's warm-up registry and kernel build cache
(`actor_critic_tpu_torch/utils/compile_cache.py`), against the cases of
JAX's `tests/test_compile_cache.py` that have a counterpart on the card:

- `bucket_size` and `pad_to_bucket` equal JAX's, and the serving engine
  pads with this one copy;
- the `--compile-cache-dir` policy (the port's: `auto` is the checkout's
  `build/`, `none` a fresh temporary directory) and `temporary_cache`;
- the native engine's library, hash-named, cold (a miss, g++ runs) then
  warm (a hit) in a temporary cache, its name moving with the source bytes
  and the flags;
- `WarmupRunner` contains a raising build and a raising capture, with
  JAX's `warmup_compile` / `warmup_done` events; a raising planner gives
  `warmup_plan_error`; a serving context plans only the serving side;
- JAX's `fused_step_thunk` rule (`fused_graphs`);
- the exporter's three compile-cache metrics, and `scripts/run_report.py`'s
  cache-hit attribution of the port's build events.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from actor_critic_tpu.utils import compile_cache as jax_cc
from actor_critic_tpu_torch import native, telemetry
from actor_critic_tpu_torch.serving import engine as engine_mod
from actor_critic_tpu_torch.utils import compile_cache

ROOT = Path(__file__).parent.parent


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------- utilities

@pytest.mark.parametrize("n,buckets", [(5, (4, 8, 16)), (8, (4, 8, 16)), (0, (4,)),
                                       (3, (16, 2, 4)), (17, (4, 8, 16)), (-1, (4,))])
def test_bucket_size_equals_jax(n, buckets):
    try:
        want = jax_cc.bucket_size(n, buckets)
    except ValueError:
        with pytest.raises(ValueError):
            compile_cache.bucket_size(n, buckets)
        return
    assert compile_cache.bucket_size(n, buckets) == want


def test_pad_to_bucket_equals_jax_and_is_the_engines():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for buckets, axis in (((4, 8), 0), ((6,), 0), ((3, 5), 1)):
        got, mask = compile_cache.pad_to_bucket(x, buckets, axis)
        want, want_mask = jax_cc.pad_to_bucket(x, buckets, axis)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mask, want_mask)
        assert got.dtype == want.dtype and mask.dtype == want_mask.dtype
    # One copy: the engine pads with this module's function and has no
    # bucket helper of its own.
    assert engine_mod.pad_to_bucket is compile_cache.pad_to_bucket
    assert not hasattr(engine_mod, "bucket_size")


def test_engine_acts_through_the_bucket_helper(monkeypatch):
    """A 3-row act pads to bucket 4 through `pad_to_bucket` and returns 3
    rows."""
    from actor_critic_tpu_torch.algos import ppo
    from actor_critic_tpu_torch.envs import make_cartpole

    spec = make_cartpole().spec
    cfg = ppo.PPOConfig(hidden=(8,))
    engine = engine_mod.PolicyEngine(spec, cfg, buckets=(1, 4), device="cpu")
    params = engine.prepare_params(engine_mod.init_params(spec, cfg))
    seen = []

    def spy(x, buckets, axis=0):
        seen.append((np.asarray(x).shape[0], buckets))
        return compile_cache.pad_to_bucket(x, buckets, axis)

    monkeypatch.setattr(engine_mod, "pad_to_bucket", spy)
    out = engine.act(params, np.zeros((3, 4), np.float32))
    assert out.shape == (3,) and seen == [(3, (1, 4))]


def test_resolve_cache_dir_policy(tmp_path):
    resolve = compile_cache.resolve_cache_dir
    ck = str(tmp_path / "ck")
    build = str(ROOT / "build")
    assert resolve("auto", ck) == build   # not JAX's <ckpt>/xla_cache sidecar
    assert resolve("auto", None) == build
    assert resolve(None, ck) == build
    assert resolve("AUTO", None) == build
    for off in ("none", "off", "", "None"):
        assert resolve(off, ck) is None
    assert resolve("/x/y", ck) == "/x/y"


def test_temporary_cache_restores_the_previous_directories(tmp_path):
    before = (compile_cache.cache_path("kernels"), compile_cache.cache_path("native"),
              compile_cache.enabled_dir())
    with compile_cache.temporary_cache(tmp_path / "a") as a:
        assert a == str(tmp_path / "a") and compile_cache.enabled_dir() == a
        assert compile_cache.cache_path("native") == tmp_path / "a" / "native"
        with compile_cache.temporary_cache(tmp_path / "b"):
            assert compile_cache.cache_path("kernels") == tmp_path / "b" / "kernels"
        assert compile_cache.cache_path("kernels") == tmp_path / "a" / "kernels"
        from actor_critic_tpu_torch import _build

        assert _build.library_path("gae").parent == tmp_path / "a" / "kernels"
    assert (compile_cache.cache_path("kernels"), compile_cache.cache_path("native"),
            compile_cache.enabled_dir()) == before


def test_fresh_cache_dir_is_empty_and_new():
    a, b = compile_cache.fresh_cache_dir(), compile_cache.fresh_cache_dir()
    assert a != b and Path(a).is_dir() and not any(Path(a).iterdir())


# ------------------------------------------------------------- build cache

def test_native_engine_cold_then_warm(tmp_path, monkeypatch):
    """A miss (g++ runs, a `compile` event without cache_hit), then a hit
    (the library found); the hash name moves with the source bytes and
    with the flags, so a stale engine is never loaded from a shared
    cache."""
    with telemetry.TelemetrySession(tmp_path / "tel", sample_resources=False):
        with compile_cache.temporary_cache(tmp_path / "cache"):
            before = compile_cache.cache_stats()
            path = native.build()
            mid = compile_cache.cache_stats()
            assert native.build() == path
            after = compile_cache.cache_stats()
    assert path.parent == tmp_path / "cache" / "native"
    assert path.name.startswith("_vecenv-") and len(path.stem) == len("_vecenv-") + 12
    assert [p.name for p in path.parent.iterdir()] == [path.name]  # no temporary left
    assert mid == {"hits": before["hits"], "misses": before["misses"] + 1}
    assert after == {"hits": before["hits"] + 1, "misses": before["misses"] + 1}
    comps = [e for e in _read_jsonl(tmp_path / "tel" / "events.jsonl") if e["kind"] == "compile"]
    assert [(e["name"], e.get("cache_hit", False)) for e in comps] == [
        ("vecenv.cpp", False), ("vecenv.cpp", True)]
    assert comps[0]["compile_s"] > 0

    with compile_cache.temporary_cache(tmp_path / "cache"):
        name = native.library_path().name
        src = tmp_path / "vecenv.cpp"
        src.write_bytes(native.SRC.read_bytes() + b"\n// edited\n")
        monkeypatch.setattr(native, "SRC", src)
        edited = native.library_path().name
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
        flagged = native.library_path().name
    assert len({name, edited, flagged}) == 3


def test_native_load_binds_once_per_library(tmp_path):
    with compile_cache.temporary_cache(tmp_path):
        before = compile_cache.cache_stats()
        lib = native.load()
        assert native.load() is lib
        after = compile_cache.cache_stats()
    # One build event (here a miss) for both loads.
    assert sum(after.values()) - sum(before.values()) == 1


# --------------------------------------------------------------- registry

def test_warmup_runner_contains_thunk_errors(tmp_path):
    ok = []
    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        runner = compile_cache.WarmupRunner(
            [("boom", lambda: 1 / 0), ("fine", lambda: ok.append(1))]).start()
        assert runner.wait(30)
        runner.close()
    assert runner.done and ok
    assert runner.results[0]["entry"] == "boom" and "error" in runner.results[0]
    assert "compile_s" in runner.results[1]
    events = _read_jsonl(tmp_path / "events.jsonl")
    rows = [e for e in events if e["kind"] == "warmup_compile"]
    assert [r["entry"] for r in rows] == ["boom", "fine"]
    assert "ZeroDivisionError" in rows[0]["error"] and "compile_s" in rows[1]
    done = [e for e in events if e["kind"] == "warmup_done"]
    assert len(done) == 1 and done[0]["entries"] == 2 and done[0]["errors"] == 1
    assert done[0]["total_s"] >= 0


def test_capture_part_runs_planned_entries_once(tmp_path, capsys):
    """A planned entry's capture part runs on the caller's thread after its
    build part, once; an entry the plan does not name is left to its owner;
    a capture that raises is contained (stderr, `error`) and reported as not
    run; `warmup_done` comes after the last capture part, and the done hooks
    see it."""
    built, ran, hooked = [], [], []

    class Build:
        captures = True

        def __call__(self):
            built.append("a")

    plan = [("a.make_train_step", Build()), ("b.make_eval_fn", compile_cache.Warmup())]
    hook = hooked.append
    compile_cache.WARMUP_DONE_HOOKS.append(hook)
    try:
        with telemetry.TelemetrySession(tmp_path, sample_resources=False):
            runner = compile_cache.WarmupRunner(plan).start()
            assert not compile_cache.capture_part("c.unplanned", lambda: ran.append("c"))
            assert compile_cache.capture_part("a.make_train_step", lambda: ran.append("a"))
            assert built == ["a"]
            assert not compile_cache.capture_part("a.make_train_step", lambda: ran.append("a2"))
            assert not runner.done
            assert not compile_cache.capture_part("b.make_eval_fn", lambda: 1 / 0)
            assert runner.done and hooked == [runner]
            # The plan is complete: no site warms any more.
            assert not compile_cache.capture_part("b.make_eval_fn", lambda: ran.append("b"))
            runner.close()
    finally:
        compile_cache.WARMUP_DONE_HOOKS.remove(hook)
    assert ran == ["a"]
    assert "warmup entry 'b.make_eval_fn' failed to capture" in capsys.readouterr().err
    rows = {r["entry"]: r for r in runner.results}
    assert set(rows["a.make_train_step"]) >= {"build_s", "capture_s", "compile_s"}
    assert "ZeroDivisionError" in rows["b.make_eval_fn"]["error"]
    kinds = [e["kind"] for e in _read_jsonl(tmp_path / "events.jsonl")
             if e["kind"].startswith("warmup")]
    assert kinds == ["warmup_compile", "warmup_compile", "warmup_done"]


def test_close_records_unreached_sites_as_skipped(tmp_path):
    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        runner = compile_cache.WarmupRunner(
            [("a.make_train_step", compile_cache.Warmup())]).start()
        runner.close()
        assert not compile_cache.capture_part("a.make_train_step", lambda: None)
    assert runner.done and runner.results[0]["skipped"]
    done = [e for e in _read_jsonl(tmp_path / "events.jsonl") if e["kind"] == "warmup_done"]
    assert done[0]["errors"] == 0


def test_raising_planner_gives_warmup_plan_error(tmp_path, capsys):
    from actor_critic_tpu_torch.algos import a2c
    from actor_critic_tpu_torch.envs import make_cartpole

    @compile_cache.register_warmup("test.raising_planner")
    def _boom(ctx):
        raise RuntimeError("factory signature drifted")

    try:
        env = make_cartpole()
        ctx = compile_cache.WarmupContext(algo="a2c", fused=True, spec=env.spec,
                                          cfg=a2c.A2CConfig(), env=env, device="cpu")
        with telemetry.TelemetrySession(tmp_path, sample_resources=False):
            names = [n for n, _ in compile_cache.plan_warmup(ctx)]
    finally:
        del compile_cache._REGISTRY["test.raising_planner"]
    assert names == ["a2c.make_train_step"]
    assert "warmup planner 'test.raising_planner' failed" in capsys.readouterr().err
    errs = [e for e in _read_jsonl(tmp_path / "events.jsonl") if e["kind"] == "warmup_plan_error"]
    assert len(errs) == 1 and errs[0]["entry"] == "test.raising_planner"
    assert "drifted" in errs[0]["error"]


def test_serving_context_plans_only_serving_planners():
    from actor_critic_tpu_torch.algos import ppo
    from actor_critic_tpu_torch.envs import make_cartpole

    spec = make_cartpole().spec
    cfg = ppo.PPOConfig(hidden=(8,))
    serve_ctx = compile_cache.WarmupContext(algo="ppo", fused=False, spec=spec, cfg=cfg,
                                            serving_buckets=(1, 4))
    assert [n for n, _ in compile_cache.plan_warmup(serve_ctx)] == ["engine.make_act_program"]
    for fused, eval_every in ((False, 0), (False, 5), (True, 5)):
        train_ctx = compile_cache.WarmupContext(algo="ppo", fused=fused, spec=spec, cfg=cfg,
                                                eval_every=eval_every)
        assert "engine.make_act_program" not in [
            n for n, _ in compile_cache.plan_warmup(train_ctx)]


@pytest.mark.parametrize("kernels_on", ["cuda", "cpu"])
def test_entries_build_the_kernels_of_their_path(kernels_on):
    """The build part names the libraries the path launches on the card
    (none on the CPU) and g++ for a native pool."""
    from actor_critic_tpu_torch.algos import impala, ppo

    plan = dict(compile_cache.plan_warmup(compile_cache.WarmupContext(
        algo="ppo", fused=False, spec=None, cfg=ppo.PPOConfig(), async_actors=2,
        device=kernels_on, native=True)))
    on_card = kernels_on == "cuda"
    assert plan["ppo.make_async_update_step"].kernels == (("vtrace",) if on_card else ())
    assert plan["ppo.make_async_update_step"].native
    plan = dict(compile_cache.plan_warmup(compile_cache.WarmupContext(
        algo="a3c", fused=True, spec=None, cfg=impala.ImpalaConfig(correction="none"),
        device=kernels_on)))
    assert plan["impala.make_train_step"].kernels == (("gae",) if on_card else ())
    assert not plan["impala.make_train_step"].native


@pytest.mark.parametrize("chunk,iterations,resume,want", [
    (1, 10, False, (1,)), (1, 10, True, (1,)),
    (4, 8, False, (4,)), (4, 10, False, (4, 1)), (4, 8, True, (4, 1)),
    (4, 3, False, (1,)), (4, 0, False, (4, 1)), (4, 0, True, (4, 1)),
])
def test_fused_graphs_is_jax_rule(chunk, iterations, resume, want):
    """JAX's `fused_step_thunk`: the full-stride program when a full chunk
    can run, the masked one when a partial chunk can."""
    assert compile_cache.fused_graphs(chunk, iterations, resume) == want
    full = chunk > 1 and (iterations == 0 or iterations >= chunk)
    partial = chunk > 1 and (resume or (iterations > 0 and iterations % chunk != 0)
                             or iterations < chunk)
    assert set(want) == ({1} if chunk <= 1 else set()) | ({chunk} if full else set()) | (
        {1} if partial else set())


# --------------------------------------------------------------- telemetry

def test_exporter_reports_compile_cache_counters(tmp_path):
    from actor_critic_tpu_torch.telemetry.exporter import render_metrics

    s = telemetry.TelemetrySession(tmp_path / "t", sample_resources=False)
    try:
        with compile_cache.temporary_cache(tmp_path / "cache"):
            native.build()  # one miss
            text = render_metrics(s)
    finally:
        s.close()
    lines = dict(line.rsplit(" ", 1) for line in text.splitlines()
                 if line.startswith("actor_critic_compile_cache"))
    stats = compile_cache.cache_stats()
    assert int(float(lines["actor_critic_compile_cache_hits_total"])) == stats["hits"]
    assert int(float(lines["actor_critic_compile_cache_misses_total"])) == stats["misses"] >= 1
    assert lines["actor_critic_compile_cache_enabled"] == "1"
    assert "# TYPE actor_critic_compile_cache_hits_total counter" in text


def test_run_report_cache_hit_attribution(tmp_path, monkeypatch):
    """JAX's unedited `scripts/run_report.py` on a port session's events: the
    native engine built cold, then found (a `cache_hit` event), is one row
    with two compiles and one hit, and the hit is named as such."""
    spec = importlib.util.spec_from_file_location("run_report", ROOT / "scripts" / "run_report.py")
    run_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_report)
    monkeypatch.setattr(run_report, "static_findings", lambda: [])
    with telemetry.TelemetrySession(tmp_path / "tel", sample_resources=False):
        with compile_cache.temporary_cache(tmp_path / "cache"):
            native.build()
            native.build()
    report = run_report.render(str(tmp_path / "tel"))
    row = [line for line in report.splitlines() if line.startswith("| `vecenv.cpp` |")]
    assert len(row) == 1 and row[0].split("|")[2:4] == [" 2 ", " 1 "], row
    assert "persistent-cache hit(s)" in report
