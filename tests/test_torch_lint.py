"""The port's static analyzer, torchlint (`actor_critic_tpu_torch/analysis/`):
its framework, CLI, baseline and suppressions, and the gate on the port's
own tree — the counterparts of the JAX package's `tests/test_jaxlint.py`
cases, one for one where they apply.

- Suppressions: same line, standalone line over a wrapped statement, per
  check, `disable=all`, the header-only rule before a block, a quoted
  pragma that is none, the `host-sync` alias, the hot-module and
  thread-owned pragmas only as comments.
- The baseline: round trip, reasons kept on regeneration, an entry gone
  stale when its line changes, a malformed file a crash.
- The CLI: exit codes 0/1/2, `--list-checks` (the 14 checks of the port
  and the alias), `--json`, `--select`, `--write-baseline` and
  `--prune-stale` scoped to what the run saw, `--diff` and `--since` in a
  scratch git repo.
- The gate: the port's tree (`actor_critic_tpu_torch/`, `chip_smoke.py`)
  has no finding the baseline does not cover, and every baseline entry
  has a reason.

Everything is `ast` over source text (the analyzer imports nothing it
scans), so each case takes milliseconds; the gate about six seconds.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from actor_critic_tpu_torch import analysis
from actor_critic_tpu_torch.analysis import baseline, core, torchlint

REPO = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "torch_lint_fixtures"

PORTED_CHECKS = (
    "tracer-leak", "prng-reuse", "recompile-hazard", "donation-aliasing", "warmup-registry",
    "lock-discipline", "publish-aliasing", "check-then-act", "collective-discipline",
    "mailbox-protocol", "rank-affinity", "transfer-discipline", "donation-discipline",
    "dispatch-granularity",
)

_SNIPPET = (
    "import torch\n"
    "def f(seed):\n"
    "    gen = torch.Generator().manual_seed(seed)\n"
    "    a = torch.randn(2, generator=gen)\n"
    "    twin = torch.Generator().manual_seed(seed){pragma}\n"
    "    return a + torch.randn(2, generator=twin)\n"
)

_HOT_BODY = (
    "def collect(act, obs, steps):\n"
    "    for _ in range(steps):\n"
    "        obs = act(obs).cpu()\n"
    "    return obs\n"
)


def _run_snippet(tmp_path, src):
    p = tmp_path / "snippet.py"
    p.write_text(src)
    return analysis.analyze_paths([str(p)], str(REPO), skip=("warmup-registry",))


def _cli(argv, capsys):
    rc = torchlint.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------


def test_suppression_same_line(tmp_path):
    assert [f.check for f in _run_snippet(tmp_path, _SNIPPET.format(pragma=""))] == [
        "prng-reuse"]
    assert _run_snippet(tmp_path, _SNIPPET.format(
        pragma="  # torchlint: disable=prng-reuse (fixture reason)")) == []


def test_suppression_standalone_line_covers_next_code_line(tmp_path):
    src = _SNIPPET.format(pragma="").replace(
        "    twin = torch.Generator()",
        "    # torchlint: disable=prng-reuse (fixture reason)\n    twin = torch.Generator()")
    assert _run_snippet(tmp_path, src) == []


def test_suppression_is_per_check(tmp_path):
    still = _run_snippet(tmp_path, _SNIPPET.format(
        pragma="  # torchlint: disable=transfer-discipline"))
    assert [f.check for f in still] == ["prng-reuse"]
    assert _run_snippet(tmp_path, _SNIPPET.format(pragma="  # torchlint: disable=all")) == []


def test_jaxlint_pragma_is_not_torchlint_pragma(tmp_path):
    """The port's pragma is its own word: JAX's spelling suppresses nothing
    here."""
    still = _run_snippet(tmp_path, _SNIPPET.format(pragma="  # jaxlint: disable=prng-reuse"))
    assert [f.check for f in still] == ["prng-reuse"]


def test_standalone_pragma_covers_multiline_statement(tmp_path):
    src = ("# torchlint: hot-module\n"
           "def collect(act, obs, steps):\n"
           "    for _ in range(steps):\n"
           "        # torchlint: disable=transfer-discipline (fixture reason)\n"
           "        obs = (\n"
           "            act(obs).cpu()\n"
           "        )\n"
           "    return obs\n")
    assert _run_snippet(tmp_path, src) == []


def test_standalone_pragma_does_not_disable_a_whole_block(tmp_path):
    src = ("# torchlint: hot-module\n"
           "def collect(act, obs, steps):\n"
           "    # torchlint: disable=transfer-discipline (header only)\n"
           "    for _ in range(steps):\n"
           "        obs = act(obs).cpu()\n"
           "    return obs\n")
    assert [f.check for f in _run_snippet(tmp_path, src)] == ["transfer-discipline"]


def test_quoted_pragma_in_comment_does_not_suppress(tmp_path):
    src = ("# torchlint: hot-module\n"
           "def collect(act, obs, steps):\n"
           "    for _ in range(steps):\n"
           "        # TODO: revisit the `# torchlint: disable=host-sync` idea\n"
           "        obs = act(obs).cpu()\n"
           "    return obs\n")
    assert [f.check for f in _run_snippet(tmp_path, src)] == ["transfer-discipline"]


def test_legacy_host_sync_pragma_still_suppresses(tmp_path):
    src = ("# torchlint: hot-module\n"
           "def collect(act, obs, steps):\n"
           "    for _ in range(steps):\n"
           "        # torchlint: disable=host-sync (the absorbed name)\n"
           "        obs = act(obs).cpu()\n"
           "    return obs\n")
    assert _run_snippet(tmp_path, src) == []


def test_hot_module_pragma_in_docstring_does_not_opt_in(tmp_path):
    doc = '"""Docs may MENTION `# torchlint: hot-module` safely."""\n'
    assert _run_snippet(tmp_path, doc + _HOT_BODY) == []
    flagged = _run_snippet(tmp_path, "# torchlint: hot-module\n" + _HOT_BODY)
    assert [f.check for f in flagged] == ["transfer-discipline"]


_COUNTER_SNIPPET = (
    "import threading\n"
    "class Svc:\n"
    "    def __init__(self):\n"
    "{anno}"
    "        self.blocks = 0\n"
    "        self._t = threading.Thread(target=self._run)\n"
    "    def _run(self):\n"
    "        while True:\n"
    "            self.blocks += 1\n"
)


def test_thread_owned_annotation_clears_the_attribute(tmp_path):
    flagged = _run_snippet(tmp_path, _COUNTER_SNIPPET.format(anno=""))
    assert [f.check for f in flagged] == ["lock-discipline"]
    assert _run_snippet(tmp_path, _COUNTER_SNIPPET.format(
        anno="        # torchlint: thread-owned=svc (fixture reason)\n")) == []


def test_thread_owned_in_docstring_does_not_annotate(tmp_path):
    src = _COUNTER_SNIPPET.format(anno="").replace(
        "    def __init__(self):\n",
        '    def __init__(self):\n        """Docs may MENTION `# torchlint: thread-owned=x`."""\n')
    assert [f.check for f in _run_snippet(tmp_path, src)] == ["lock-discipline"]


def test_cta_window_with_two_writes_flags_once(tmp_path):
    src = ("import threading\n"
           "class Reg:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self._subs = []\n"
           "    def add(self, x):\n"
           "        if x in self._subs:\n"
           "            return\n"
           "        self._subs.append(x)\n"
           "        self._subs.sort()\n")
    assert [f.check for f in _run_snippet(tmp_path, src)] == ["check-then-act"]


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def _prng_findings():
    return analysis.analyze_paths([str(FIXTURES / "prng_reuse_flag.py")], str(REPO),
                                  skip=("warmup-registry",))


def test_baseline_round_trip(tmp_path):
    findings = _prng_findings()
    assert findings
    path = tmp_path / "baseline.json"
    analysis.save_baseline(str(path), analysis.regenerate(findings, []))
    entries = analysis.load_baseline(str(path))
    new, matched, stale = analysis.apply_baseline(findings, entries)
    assert new == [] and len(matched) == len(findings) and stale == []
    entries[0]["reason"] = "audited: deliberate"
    assert any(e["reason"] == "audited: deliberate"
               for e in analysis.regenerate(findings, entries))


def test_baseline_goes_stale_when_the_line_changes():
    findings = _prng_findings()
    entries = analysis.regenerate(findings, [])
    entries[0]["line_text"] = "edited since the entry was written"
    new, _matched, stale = analysis.apply_baseline(findings, entries)
    assert new and stale


def test_fingerprint_leaves_the_line_number_out():
    f = _prng_findings()[0]
    moved = core.Finding(f.check, f.path, f.line + 40, f.col, f.message, f.context, f.line_text)
    assert moved.fingerprint() == f.fingerprint()
    assert str(f.line) not in f.fingerprint().split(":", 2)[2].split(":")[0]


def test_malformed_baseline_is_a_crash_not_a_clean_run(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text("{not json")
    with pytest.raises(analysis.AnalysisError):
        analysis.load_baseline(str(path))
    path.write_text('{"entries": 3}')
    with pytest.raises(analysis.AnalysisError):
        analysis.load_baseline(str(path))


def test_default_baseline_lives_beside_the_analyzer():
    assert Path(analysis.default_baseline_path(str(REPO))) == (
        REPO / "actor_critic_tpu_torch" / "analysis" / "torchlint_baseline.json")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_list_checks_names_the_fourteen(capsys):
    rc, out, _ = _cli(["--list-checks"], capsys)
    assert rc == 0
    names = [line.split()[0] for line in out.splitlines() if line.strip()]
    assert sorted(names) == sorted(PORTED_CHECKS)
    assert "host-sync" in out  # the absorbed name, in transfer-discipline's doc
    assert core.CHECK_ALIASES == {"host-sync": "transfer-discipline"}


def test_select_host_sync_alias_resolves(capsys):
    rc, _, _ = _cli([str(FIXTURES / "transfer_discipline_flag.py"), "--no-baseline",
                     "--select", "host-sync"], capsys)
    assert rc == 1
    rc, _, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--no-baseline",
                     "--select", "host-sync"], capsys)
    assert rc == 0


def test_cli_exit_codes_distinguish_findings_from_crashes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert _cli([str(clean), "--no-baseline"], capsys)[0] == 0
    flag = str(FIXTURES / "prng_reuse_flag.py")
    assert _cli([flag, "--no-baseline", "--error-on-new"], capsys)[0] == 1
    broken = tmp_path / "broken.py"
    broken.write_text("def (:\n")
    assert _cli([str(broken), "--no-baseline"], capsys)[0] == 2
    assert _cli([str(tmp_path / "missing.py"), "--no-baseline"], capsys)[0] == 2
    assert _cli([flag, "--no-baseline", "--checks", "no-such"], capsys)[0] == 2
    bad = tmp_path / "bad.json"
    bad.write_text("[")
    assert _cli([flag, "--baseline", str(bad)], capsys)[0] == 2


def test_cli_module_entry_point_exit_codes(tmp_path):
    """`python -m actor_critic_tpu_torch.analysis.torchlint` is the CLI: 1
    on findings, 2 on a crash."""
    flag = str(FIXTURES / "prng_reuse_flag.py")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "actor_critic_tpu_torch.analysis.torchlint", *a],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    found = run(flag, "--no-baseline")
    assert found.returncode == 1 and "[prng-reuse]" in found.stdout
    assert run(str(tmp_path / "missing.py")).returncode == 2


def test_cli_json_mode(capsys):
    rc, out, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--no-baseline", "--json"], capsys)
    assert rc == 1
    payload = json.loads(out)
    assert payload["counts"]["new"] >= 1 and payload["counts"]["stale"] == 0
    assert all(f["check"] == "prng-reuse" for f in payload["new"])


def test_select_runs_only_the_named_checks(capsys):
    flag = str(FIXTURES / "prng_reuse_flag.py")
    assert _cli([flag, "--no-baseline", "--select", "host-sync,lock-discipline"], capsys)[0] == 0
    assert _cli([flag, "--no-baseline", "--select", "prng-reuse"], capsys)[0] == 1
    assert _cli([flag, "--select", "no-such"], capsys)[0] == 2


def test_write_baseline_scoped_run_keeps_out_of_scope_entries(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    foreign = {"check": "transfer-discipline", "path": "some/other/file.py", "context": "f",
               "line_text": "x = y.cpu()", "reason": "audited elsewhere"}
    analysis.save_baseline(str(bl), [foreign])
    rc, _, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--baseline", str(bl),
                     "--write-baseline"], capsys)
    assert rc == 0
    entries = analysis.load_baseline(str(bl))
    assert any(e.get("reason") == "audited elsewhere" for e in entries)
    assert any(e.get("check") == "prng-reuse" and e["reason"].startswith("NEEDS-REASON")
               for e in entries)


def test_write_baseline_refuses_no_baseline(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    analysis.save_baseline(str(bl), [{"check": "prng-reuse", "path": "p.py", "context": "f",
                                      "line_text": "x", "reason": "audited"}])
    rc, _, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--baseline", str(bl),
                     "--no-baseline", "--write-baseline"], capsys)
    assert rc == 2
    assert analysis.load_baseline(str(bl))[0]["reason"] == "audited"


def test_prune_stale_drops_only_in_scope_dead_entries(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    dead_in_scope = {"check": "prng-reuse",
                     "path": "tests/torch_lint_fixtures/prng_reuse_flag.py", "context": "f",
                     "line_text": "this line no longer exists", "reason": "went stale"}
    out_of_scope = {"check": "transfer-discipline", "path": "some/other/file.py",
                    "context": "g", "line_text": "x = y.cpu()", "reason": "audited elsewhere"}
    live = analysis.regenerate(_prng_findings(), [])
    for e in live:
        e["reason"] = "kept"
    analysis.save_baseline(str(bl), [dead_in_scope, out_of_scope, *live])
    rc, out, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--baseline", str(bl),
                       "--prune-stale"], capsys)
    assert rc == 0 and "pruned 1" in out
    reasons = {e["reason"] for e in analysis.load_baseline(str(bl))}
    assert reasons == {"audited elsewhere", "kept"}


def test_prune_stale_refuses_no_baseline(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    analysis.save_baseline(str(bl), [{"check": "prng-reuse", "path": "p.py", "context": "f",
                                      "line_text": "x", "reason": "audited"}])
    rc, _, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--baseline", str(bl),
                     "--no-baseline", "--prune-stale"], capsys)
    assert rc == 2
    assert analysis.load_baseline(str(bl))[0]["reason"] == "audited"


def test_show_baselined_prints_the_reasons(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    entries = analysis.regenerate(_prng_findings(), [])
    for e in entries:
        e["reason"] = "audited: a fixture"
    analysis.save_baseline(str(bl), entries)
    rc, out, _ = _cli([str(FIXTURES / "prng_reuse_flag.py"), "--baseline", str(bl),
                       "--show-baselined"], capsys)
    assert rc == 0 and "[baselined: audited: a fixture]" in out


def test_stale_warnings_are_check_scoped(capsys):
    rc, _, err = _cli(["actor_critic_tpu_torch/algos", "--select", "prng-reuse"], capsys)
    assert rc == 0, err
    assert "stale" not in err


def test_partial_scan_reports_no_stale_entries(capsys):
    """One file of the tree against the repo baseline: the other files'
    entries and the registry's other keys are not stale."""
    rc, _, err = _cli(["actor_critic_tpu_torch/algos/host_loop.py"], capsys)
    assert rc == 0, err
    assert "stale" not in err


def _scratch_repo(tmp_path):
    root = tmp_path / "scratch"
    root.mkdir()
    git = ["git", "-C", str(root), "-c", "user.email=t@t", "-c", "user.name=t"]
    subprocess.run([*git[:3], "init", "-q"], check=True)
    (root / "clean.py").write_text("x = 1\n")
    (root / "hot.py").write_text("y = 2\n")
    subprocess.run([*git, "add", "-A"], check=True)
    subprocess.run([*git, "commit", "-qm", "seed"], check=True)
    return root, git


_FLAGGED = _SNIPPET.format(pragma="")


def test_diff_mode_lints_only_changed_files(tmp_path, capsys, monkeypatch):
    root, _ = _scratch_repo(tmp_path)
    monkeypatch.setattr(torchlint, "REPO", str(root))
    rc, out, _ = _cli(["clean.py", "hot.py", "--no-baseline", "--diff", "HEAD"], capsys)
    assert rc == 0 and "nothing to lint" in out
    (root / "hot.py").write_text(_FLAGGED)
    rc, out, _ = _cli(["clean.py", "hot.py", "--no-baseline", "--diff", "HEAD", "--json",
                       "--skip", "warmup-registry"], capsys)
    assert rc == 1
    assert {f["path"] for f in json.loads(out)["new"]} == {"hot.py"}
    rc, out, _ = _cli(["clean.py", "--no-baseline", "--diff", "HEAD"], capsys)
    assert rc == 0 and "nothing to lint" in out
    assert _cli(["clean.py", "--no-baseline", "--diff", "no-such-ref"], capsys)[0] == 2


def test_since_mode_includes_untracked_files(tmp_path, capsys, monkeypatch):
    root, _ = _scratch_repo(tmp_path)
    monkeypatch.setattr(torchlint, "REPO", str(root))
    (root / "fresh.py").write_text(_FLAGGED)
    rc, out, _ = _cli(["fresh.py", "--no-baseline", "--diff", "HEAD"], capsys)
    assert rc == 0 and "nothing to lint" in out
    rc, out, _ = _cli(["fresh.py", "--no-baseline", "--since", "HEAD", "--json",
                       "--skip", "warmup-registry"], capsys)
    assert rc == 1 and {f["path"] for f in json.loads(out)["new"]} == {"fresh.py"}


def test_since_mode_resolves_revs_and_rejects_typos(tmp_path, capsys, monkeypatch):
    root, _ = _scratch_repo(tmp_path)
    monkeypatch.setattr(torchlint, "REPO", str(root))
    rc, out, _ = _cli(["clean.py", "--no-baseline", "--since", "HEAD"], capsys)
    assert rc == 0 and "nothing to lint" in out
    rc, _, err = _cli(["clean.py", "--no-baseline", "--since", "no-such-rev"], capsys)
    assert rc == 2 and "not a resolvable rev" in err
    assert _cli(["clean.py", "--no-baseline", "--since", "HEAD", "--diff", "HEAD"],
                capsys)[0] == 2


def test_since_mode_fixture_pair_relints_the_pass_module(tmp_path, capsys, monkeypatch):
    """A change to a check's fixture pair alone re-lints the module that
    implements the check."""
    root, git = _scratch_repo(tmp_path)
    (root / "passmod.py").write_text("z = 3\n")
    subprocess.run([*git, "add", "-A"], check=True)
    subprocess.run([*git, "commit", "-qm", "pass module"], check=True)
    modname = "torchlint_scratch_pass"
    mod = types.ModuleType(modname)
    mod.__file__ = str(root / "passmod.py")
    monkeypatch.setitem(sys.modules, modname, mod)

    def scratch_check(mod_info):
        return []

    scratch_check.__module__ = modname
    core.register_check("scratch-pair", "test-only")(scratch_check)
    monkeypatch.setattr(torchlint, "REPO", str(root))
    try:
        fixdir = root / "tests" / "torch_lint_fixtures"
        fixdir.mkdir(parents=True)
        (fixdir / "scratch_pair_flag.py").write_text("w = 4\n")
        rc, out, _ = _cli(["passmod.py", "--no-baseline", "--since", "HEAD",
                           "--skip", "warmup-registry"], capsys)
        assert rc == 0 and "nothing to lint" not in out and "0 new finding(s)" in out
    finally:
        core._CHECKS.pop("scratch-pair", None)


# ---------------------------------------------------------------------------
# the gate: the port's tree
# ---------------------------------------------------------------------------


def test_port_tree_is_clean(capsys):
    """`python -m actor_critic_tpu_torch.analysis.torchlint` exits 0: no
    finding on `actor_critic_tpu_torch/` and `chip_smoke.py` that the
    baseline does not cover, and no stale entry."""
    rc, out, err = _cli(["--error-on-new"], capsys)
    assert rc == 0, f"torchlint found new findings:\n{out}\n{err}"
    assert "0 stale baseline entries" in out, err


def test_every_baseline_entry_has_a_reason():
    entries = analysis.load_baseline(analysis.default_baseline_path(str(REPO)))
    assert entries
    for e in entries:
        assert set(e) == {"check", "path", "context", "line_text", "reason"}, e
        assert e["check"] in PORTED_CHECKS, e
        reason = e["reason"].strip()
        assert len(reason) > 30 and not reason.startswith("NEEDS-REASON"), e


def test_default_scan_is_the_port_and_its_smoke_script():
    assert torchlint.DEFAULT_PATHS == ("actor_critic_tpu_torch", "chip_smoke.py")
    assert Path(torchlint.REPO) == REPO


def test_the_analyzer_imports_neither_jax_nor_the_jax_package():
    """The analyzer's own modules import nothing of JAX (their source; the
    port-wide guard is tests/test_torch_guards.py)."""
    import ast

    for path in sorted((REPO / "actor_critic_tpu_torch" / "analysis").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "flax", "optax", "actor_critic_tpu"), (path, n)


def test_baseline_module_round_trips_through_the_cli_format(tmp_path):
    entries = [{"check": "prng-reuse", "path": "b.py", "context": "g", "line_text": "y",
                "reason": "r"},
               {"check": "lock-discipline", "path": "a.py", "context": "f", "line_text": "x",
                "reason": "r"}]
    p = tmp_path / "bl.json"
    baseline.save_baseline(str(p), entries)
    data = json.loads(p.read_text())
    assert data["version"] == 1
    assert [e["path"] for e in data["entries"]] == ["a.py", "b.py"]  # sorted by fingerprint
