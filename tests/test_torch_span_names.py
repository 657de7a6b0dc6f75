"""Static check on the port: every phase-span name in
`actor_critic_tpu_torch/` and `chip_smoke.py` is canonical (JAX's
`tests/test_span_names.py`, the same scan). `scripts/run_report.py`'s
phase breakdown groups spans by NAME, so a typo'd span would raise nowhere
and grow a one-off row. The port's `CANONICAL_PHASES` is JAX's set."""

import re
from pathlib import Path

from actor_critic_tpu import telemetry as jtelemetry
from actor_critic_tpu_torch import telemetry

REPO = Path(__file__).parent.parent
SCAN = ["actor_critic_tpu_torch", "chip_smoke.py"]

_CALL = re.compile(
    r"""(?:telemetry|_session)\s*\.\s*
        (?:span|complete_span|instant)\s*\(\s*
        (['"])(?P<name>[^'"]+)\1
    """,
    re.VERBOSE,
)
_FOREIGN = re.compile(r"""\.\s*complete(?:_foreign)?\s*\(\s*(['"])(?P<name>[^'"]+)\1""")
_CONST = re.compile(r"""^\s*\w+_PHASE\s*=\s*(['"])(?P<name>[^'"]+)\1""", re.MULTILINE)


def _span_names() -> dict[str, set[str]]:
    """{span name: {files using it}} across the scanned source (the
    tracer-level `complete(...)` of the serving hops included)."""
    uses: dict[str, set[str]] = {}
    for root in SCAN:
        path = REPO / root
        files = [path] if path.is_file() else sorted(path.rglob("*.py"))
        for f in files:
            text = f.read_text()
            for pat in (_CALL, _FOREIGN, _CONST):
                for m in pat.finditer(text):
                    uses.setdefault(m.group("name"), set()).add(str(f.relative_to(REPO)))
    return uses


def test_every_span_name_is_canonical():
    uses = _span_names()
    assert uses, "scanner found no span call sites"
    rogue = {name: sorted(files) for name, files in uses.items()
             if name not in telemetry.CANONICAL_PHASES}
    assert not rogue, (f"non-canonical span name(s) {rogue}: add to telemetry/spans.py "
                       "CANONICAL_PHASES or fix the typo")
    assert telemetry.CANONICAL_PHASES == jtelemetry.CANONICAL_PHASES


def test_core_phases_are_instrumented():
    """The phases the run report's breakdown documents are emitted somewhere
    in the port (the sharded pool's `env_step_worker` is not ported)."""
    uses = _span_names()
    for phase in ("iteration", "env_step", "update", "log", "checkpoint", "eval",
                  "host_to_device", "queue_wait", "profile", "serve_request", "serve_parse",
                  "serve_queue_wait", "serve_dispatch", "serve_respond"):
        assert phase in uses, f"phase {phase!r} no longer instrumented"
