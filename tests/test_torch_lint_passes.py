"""The passes of the port's static analyzer, held against the JAX package's
analyzer (`actor_critic_tpu.analysis`) and against the port's own modules.

- Fixture pairs (`tests/torch_lint_fixtures/`): each flag file gives
  findings of its check only, each ok twin none.
- Parity with JAX: for the five checks about Python and files
  (check-then-act, publish-aliasing, mailbox-protocol, rank-affinity, and
  lock-discipline's flag file, whose ok twin carries JAX's pragma word),
  JAX's own fixture gives both analyzers the same set of (check, line). For
  every other check, the port's (check, line) set on its twin equals JAX's
  on the line-aligned original.
- Reverts: a fix of the port's own code undone in a copy of the real
  module trips exactly its check (the generator registration of
  `loop.CapturedStep`, a `.item()` in A2C's train step, the fused loop's
  capture cache, the device plane's consume, the per-thread span stacks,
  the mailbox's torn-read tolerance), and the real module sweeps clean.
- The warm-up registry: the pass and its standalone shim
  (`utils/warmup_lint.py`) give the same findings on a fixture.

Files are parsed, never imported; every case takes milliseconds.
"""

from pathlib import Path

import pytest

from actor_critic_tpu import analysis as jax_analysis
from actor_critic_tpu_torch import analysis
from actor_critic_tpu_torch.analysis import warmup
from actor_critic_tpu_torch.utils import warmup_lint

REPO = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "torch_lint_fixtures"
JAX_FIXTURES = Path(__file__).parent / "jaxlint_fixtures"
PORT = REPO / "actor_critic_tpu_torch"

PAIRS = [
    ("tracer-leak", "tracer_leak"),
    ("prng-reuse", "prng_reuse"),
    ("recompile-hazard", "recompile_hazard"),
    ("donation-aliasing", "donation_aliasing"),
    ("lock-discipline", "lock_discipline"),
    ("publish-aliasing", "publish_aliasing"),
    ("check-then-act", "check_then_act"),
    ("collective-discipline", "collective_discipline"),
    ("mailbox-protocol", "mailbox_protocol"),
    ("rank-affinity", "rank_affinity"),
    ("transfer-discipline", "transfer_discipline"),
    ("donation-discipline", "donation_discipline"),
    ("dispatch-granularity", "dispatch_granularity"),
]
# The checks about Python and files: JAX's own fixture files, fed to both.
PURE_PYTHON = [
    "check_then_act_flag.py", "check_then_act_ok.py", "publish_aliasing_flag.py",
    "publish_aliasing_ok.py", "mailbox_protocol_flag.py", "mailbox_protocol_ok.py",
    "rank_affinity_flag.py", "rank_affinity_ok.py", "lock_discipline_flag.py",
]


def _port(*paths, checks=None):
    return analysis.analyze_paths([str(p) for p in paths], str(REPO), checks=checks,
                                  skip=() if checks else ("warmup-registry",))


def _jax(*paths):
    return jax_analysis.analyze_paths([str(p) for p in paths], str(REPO),
                                      skip=("warmup-registry",))


def _lines(findings):
    return sorted({(f.check, f.line) for f in findings})


# ---------------------------------------------------------------------------
# fixture pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check,stem", PAIRS)
def test_flag_fixture_flags(check, stem):
    findings = _port(FIXTURES / f"{stem}_flag.py")
    assert findings, f"{stem}_flag.py produced no findings"
    assert {f.check for f in findings} == {check}, [f.render() for f in findings]


@pytest.mark.parametrize("check,stem", PAIRS)
def test_ok_fixture_stays_clean(check, stem):
    findings = _port(FIXTURES / f"{stem}_ok.py")
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("check,stem", PAIRS)
def test_twin_flags_jax_lines(check, stem):
    """The port's (check, line) set on its twin = JAX's on the original."""
    want = _lines(_jax(JAX_FIXTURES / f"{stem}_flag.py"))
    assert want and {c for c, _ in want} == {check}
    assert _lines(_port(FIXTURES / f"{stem}_flag.py")) == want


@pytest.mark.parametrize("name", PURE_PYTHON)
def test_jax_fixture_same_findings_in_both(name):
    assert _lines(_port(JAX_FIXTURES / name)) == _lines(_jax(JAX_FIXTURES / name))


def test_jax_lock_ok_fixture_needs_the_port_pragma():
    """JAX's ok twin is clean to JAX through `# jaxlint: thread-owned`;
    the port reads only its own word, and its twin (the same file with
    `# torchlint:`) is clean."""
    assert _jax(JAX_FIXTURES / "lock_discipline_ok.py") == []
    assert _lines(_port(JAX_FIXTURES / "lock_discipline_ok.py")) == [("lock-discipline", 35)]
    jax_text = (JAX_FIXTURES / "lock_discipline_ok.py").read_text()
    assert (FIXTURES / "lock_discipline_ok.py").read_text() == jax_text.replace(
        "jaxlint: thread-owned", "torchlint: thread-owned")


def test_warmup_registry_fixture_pair():
    mods = analysis.load_modules([str(FIXTURES / "warmup_registry_flag.py"),
                                  str(FIXTURES / "warmup_registry_ok.py")], str(REPO))
    sites = warmup.sites_from_modules(mods, "tests/", scan_dirs=("torch_lint_fixtures",))
    assert set(sites) == {"warmup_registry_flag.make_step", "warmup_registry_ok.make_step"}
    entries = {"warmup_registry_ok.make_step": ("a2c.make_train_step",)}
    found = warmup.site_findings(sites, {"a2c.make_train_step"}, entries, {})
    assert [f.check for f in found] == ["warmup-registry"]
    assert "warmup_registry_flag.make_step" in found[0].message
    assert found[0].line == 12
    both = {**entries, "warmup_registry_flag.make_step": ("a2c.make_train_step",)}
    assert warmup.site_findings(sites, {"a2c.make_train_step"}, both, {}) == []
    stale = warmup.site_findings(sites, {"a2c.make_train_step"}, both,
                                 {"gone.make_step": "reason"})
    assert len(stale) == 1 and "stale compile_cache key" in stale[0].message


def test_warmup_shim_and_pass_agree_on_a_fixture(tmp_path):
    """`utils/warmup_lint.py` (the standalone lint) and the
    `warmup-registry` pass find the same sites, keys and lines."""
    (tmp_path / "algos").mkdir()
    for stem in ("warmup_registry_flag", "warmup_registry_ok"):
        (tmp_path / "algos" / f"{stem}.py").write_text((FIXTURES / f"{stem}.py").read_text())
    shim_sites = warmup_lint.collect_sites(tmp_path, ("algos",))
    mods = analysis.load_modules([str(tmp_path / "algos")], str(tmp_path))
    pass_sites = warmup.sites_from_modules(mods, "", scan_dirs=("algos",))
    assert shim_sites == pass_sites
    entries = {"warmup_registry_ok.make_step": ("a2c.make_train_step",),
               "gone.site": ("a2c.make_train_step",)}
    shim = warmup_lint.findings(shim_sites, {"a2c.make_train_step"}, entries, {})
    found = warmup.site_findings(pass_sites, {"a2c.make_train_step"}, entries, {})
    assert len(shim) == len(found) == 2
    for line, f in zip(shim, found):
        assert line.endswith(f.message)
        if f.path != "actor_critic_tpu_torch/utils/compile_cache.py":
            assert line.startswith(f"{f.path}:{f.line}: ")


def test_warmup_pass_holds_the_port_registry():
    """Over the port's tree the pass sees the capture sites the shim sees."""
    mods = analysis.load_modules(["actor_critic_tpu_torch"], str(REPO))
    pass_sites = warmup.sites_from_modules(mods, "actor_critic_tpu_torch/")
    shim_sites = warmup_lint.collect_sites()
    assert set(pass_sites) == set(shim_sites)
    assert {k: [ln for _, ln in v] for k, v in pass_sites.items()} == {
        k: [ln for _, ln in v] for k, v in shim_sites.items()}
    assert analysis.run_checks(mods, checks=["warmup-registry"]) == []


# ---------------------------------------------------------------------------
# reverts of the port's own fixes
# ---------------------------------------------------------------------------


def _revert(tmp_path, relpath, old, new, extra=()):
    """A copy of the port's module `relpath` with `old` replaced by `new`
    (each exactly once), analyzed under its own name."""
    src = (PORT / relpath).read_text()
    for a, b in ((old, new), *extra):
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    path = tmp_path / "actor_critic_tpu_torch" / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return analysis.analyze_paths([str(path)], str(tmp_path), skip=("warmup-registry",))


REVERTS = {
    "prng-reuse": ("algos/loop.py",
                   "        self.graph.register_generator_state(state.generator)\n", "", ()),
    "tracer-leak": ("algos/a2c.py", "        traj = rollout(env, cfg, state)\n",
                    "        traj = rollout(env, cfg, state)\n"
                    "        seen = state.step_counter.item()\n", ()),
    "recompile-hazard": ("algos/loop.py", "                if n not in captured:\n",
                         "                if True:\n", ()),
    "transfer-discipline": ("algos/host_loop.py",
                            "            self.queue.select(block)\n            return\n",
                            "            for name, value in self.queue.gather(block).items():\n"
                            "                self.scalars[name] = value.cpu()\n"
                            "            return\n", ()),
    "lock-discipline": ("telemetry/session.py",
                        "        _thread_stack().append((self._name, self._t0))\n",
                        "        _OPEN_SPANS.append((self._name, self._t0))\n",
                        (("_OPEN_LOCK = threading.Lock()\n",
                          "_OPEN_LOCK = threading.Lock()\n_OPEN_SPANS = []\n"),
                         ("        stack = _thread_stack()\n        if stack and",
                          "        stack = _OPEN_SPANS\n        if stack and"))),
    "mailbox-protocol": ("parallel/multihost.py",
                         "    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):\n"
                         "        return None\n    return version, leaves\n",
                         "    except (OSError, KeyError, ValueError):\n"
                         "        return None\n    return version, leaves\n", ()),
}


@pytest.mark.parametrize("check", sorted(REVERTS))
def test_revert_trips_exactly_its_check(tmp_path, check):
    relpath, old, new, extra = REVERTS[check]
    flagged = _revert(tmp_path, relpath, old, new, extra)
    assert flagged, f"reverting {relpath} was NOT caught"
    assert {f.check for f in flagged} == {check}, [f.render() for f in flagged]


@pytest.mark.parametrize("check", sorted(REVERTS))
def test_real_module_sweeps_clean(check):
    relpath = REVERTS[check][0]
    assert analysis.analyze_paths([str(PORT / relpath)], str(REPO), checks=[check]) == []


def test_torn_reader_message_names_the_missing_exceptions(tmp_path):
    relpath, old, new, extra = REVERTS["mailbox-protocol"]
    flagged = _revert(tmp_path, relpath, old, new, extra)
    assert len(flagged) == 1 and "BadZipFile" in flagged[0].message


def test_span_stack_revert_flags_the_push(tmp_path):
    relpath, old, new, extra = REVERTS["lock-discipline"]
    flagged = _revert(tmp_path, relpath, old, new, extra)
    assert all("_OPEN_SPANS" in f.message for f in flagged)


def test_unregistered_capture_message_says_what_torch_does(tmp_path):
    relpath, old, new, extra = REVERTS["prng-reuse"]
    flagged = _revert(tmp_path, relpath, old, new, extra)
    assert len(flagged) == 1 and "register_generator_state" in flagged[0].message
    assert "raise" in flagged[0].message


_GLOBAL_CLOCK_POLL = (
    "def poll(mailbox, schedule):\n"
    "    newest = -1\n"
    "    for peer in schedule:\n"
    "        out = mailbox.read(peer)\n"
    "        if out is None:\n"
    "            continue\n"
    "        version, params = out\n"
    "        if version > newest:\n"
    "            newest = version\n"
    "            mailbox.deposit(params, version, peer)\n"
)


def _snippet(tmp_path, src, checks=None):
    p = tmp_path / "snippet.py"
    p.write_text(src)
    return analysis.analyze_paths([str(p)], str(REPO), checks=checks,
                                  skip=() if checks else ("warmup-registry",))


def test_global_version_clock_trips_mailbox_protocol(tmp_path):
    flagged = _snippet(tmp_path, _GLOBAL_CLOCK_POLL)
    assert [f.check for f in flagged] == ["mailbox-protocol"]
    assert "PER RANK" in flagged[0].message


def test_out_of_place_replay_insert_trips_donation_discipline(tmp_path):
    """The ring's insert written as a rebuild (`torch.cat`) where
    `replay/buffer.py` writes in place."""
    src = ("import torch\n"
           "def add_batch(replay, batch):\n"
           "    replay.storage = torch.cat([replay.storage[len(batch):], batch])\n"
           "    return replay\n")
    assert [f.check for f in _snippet(tmp_path, src)] == ["donation-discipline"]
    fixed = src.replace("    replay.storage = torch.cat([replay.storage[len(batch):], batch])\n",
                        "    replay.storage[: len(batch)].copy_(batch)\n")
    assert _snippet(tmp_path, fixed) == []


def test_python_reduction_over_replays_trips_dispatch_granularity(tmp_path):
    src = ("import torch\n"
           "def drain(graphs, blocks):\n"
           "    for b in blocks:\n"
           "        total = sum(g.replay()['loss'] for g in graphs)\n"
           "    return total\n")
    flagged = _snippet(tmp_path, src)
    assert "dispatch-granularity" in {f.check for f in flagged}


# ---------------------------------------------------------------------------
# near misses that stay clean (the port's own idioms)
# ---------------------------------------------------------------------------


def test_capture_cache_under_a_guard_is_clean(tmp_path):
    src = ("from actor_critic_tpu_torch.algos import loop\n"
           "def run(step, state, n, k):\n"
           "    captured = {}\n"
           "    for _ in range(k):\n"
           "        if n not in captured:\n"
           "            captured[n] = loop.CapturedStep(step, state, n)\n"
           "        captured[n].replay()\n")
    assert _snippet(tmp_path, src) == []


def test_cpu_and_device_generators_from_one_seed_are_clean(tmp_path):
    """The weights' CPU generator and the trainer's device generator seeded
    alike (every trainer's init_state) are two kinds of stream."""
    src = ("import torch\n"
           "def init_state(seed, device):\n"
           "    weights = torch.Generator().manual_seed(seed)\n"
           "    generator = torch.Generator(device=device).manual_seed(seed)\n"
           "    return weights, generator\n")
    assert _snippet(tmp_path, src) == []
    same = src.replace("torch.Generator().manual_seed", "torch.Generator(device=device).manual_seed")
    assert [f.check for f in _snippet(tmp_path, same)] == ["prng-reuse"]


def test_reseed_in_a_loop_trips_prng_reuse(tmp_path):
    src = ("import torch\n"
           "def rollout(seed, steps):\n"
           "    out = []\n"
           "    for _ in range(steps):\n"
           "        g = torch.Generator().manual_seed(seed)\n"
           "        out.append(torch.randn((), generator=g))\n"
           "    return out\n")
    assert [f.check for f in _snippet(tmp_path, src)] == ["prng-reuse"]
    fixed = src.replace("manual_seed(seed)", "manual_seed(seed + i)").replace(
        "for _ in", "for i in")
    assert _snippet(tmp_path, fixed) == []


def test_identity_and_metadata_branches_in_a_captured_step_are_clean(tmp_path):
    src = ("def make_train_step(env, cfg):\n"
           "    graphed = {}\n"
           "    def train_step(state):\n"
           "        if not state.ep_return.is_cuda:\n"
           "            return state\n"
           "        if graphed.get('state') is not state:\n"
           "            graphed['state'] = state\n"
           "        if state.obs.shape[0] > 1 and state.obs.dim() == 2:\n"
           "            return state\n"
           "        return state\n"
           "    return train_step\n")
    assert _snippet(tmp_path, src) == []


def test_restored_values_copied_in_place_are_clean(tmp_path):
    src = ("def resume(ckpt, captured, state):\n"
           "    restored = ckpt.restore(state)\n"
           "    for k, t in state.tensors.items():\n"
           "        t.copy_(restored[k])\n"
           "    return captured.replay()\n")
    assert _snippet(tmp_path, src) == []


def test_replay_outputs_read_before_the_next_replay_are_clean(tmp_path):
    src = ("def log(step, n):\n"
           "    rows = []\n"
           "    for _ in range(n):\n"
           "        metrics = step.replay()\n"
           "        rows.append({k: float(v) for k, v in metrics.items()})\n"
           "    return rows\n")
    # (transfer-discipline rightly flags the per-step float() read)
    assert _snippet(tmp_path, src, checks=["donation-aliasing"]) == []
    kept = src.replace("rows.append({k: float(v) for k, v in metrics.items()})",
                       "rows.append(metrics)")
    assert [f.check for f in _snippet(tmp_path, kept, checks=["donation-aliasing"])] == [
        "donation-aliasing"]
