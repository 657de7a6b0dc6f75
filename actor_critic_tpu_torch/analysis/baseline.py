"""torchlint's baseline: accepted findings with their reasons, matched by
the line-number-free fingerprint (the port's counterpart of
`actor_critic_tpu/analysis/baseline.py`).

An entry records a finding someone LOOKED AT and kept: each carries a
`reason` a reviewer can audit, as `compile_cache.EXEMPT` does. The gate
fails on a finding no entry covers, so a new hazard shows at once, and an
accepted one stays visible under `--show-baselined`.

Matching is by `Finding.fingerprint()` (check, path, enclosing top-level
function, stripped line text), so an entry survives edits elsewhere in its
file. When the flagged LINE changes, the entry goes stale (reported, never
dropped silently) and the finding comes back as new: a changed line wants
a fresh look.

The port's file is `actor_critic_tpu_torch/analysis/torchlint_baseline.json`.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from actor_critic_tpu_torch.analysis.core import AnalysisError, Finding

DEFAULT_RELPATH = os.path.join("actor_critic_tpu_torch", "analysis", "torchlint_baseline.json")
_PLACEHOLDER_REASON = ("NEEDS-REASON: accepted by --write-baseline; replace with why this "
                       "finding is deliberate")


def entry_fingerprint(entry: dict) -> str:
    return (f"{entry.get('check', '')}:{entry.get('path', '')}:"
            f"{entry.get('context', '')}:{entry.get('line_text', '')}")


def load_baseline(path: str) -> list[dict]:
    """The entries; [] when the file does not exist. A file that exists
    but does not parse is an AnalysisError (exit 2), never an empty
    baseline."""
    if not os.path.exists(path):
        return []
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        raise AnalysisError(f"baseline {path}: {e}") from e
    if not isinstance(data, dict) or not isinstance(data.get("entries"), list):
        raise AnalysisError(f"baseline {path}: expected {{'version': 1, 'entries': [...]}}")
    return list(data["entries"])


def save_baseline(path: str, entries: Iterable[dict]) -> None:
    entries = sorted(entries, key=entry_fingerprint)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2)
        f.write("\n")


def apply_baseline(findings: list[Finding], entries: list[dict]
                   ) -> tuple[list[Finding], list[tuple[Finding, dict]], list[dict]]:
    """(new findings, baselined (finding, entry) pairs, stale entries). One
    entry covers every finding with its fingerprint."""
    by_fp = {entry_fingerprint(e): e for e in entries}
    new: list[Finding] = []
    matched: list[tuple[Finding, dict]] = []
    used: set[str] = set()
    for f in findings:
        entry = by_fp.get(f.fingerprint())
        if entry is None:
            new.append(f)
        else:
            matched.append((f, entry))
            used.add(f.fingerprint())
    stale = [e for fp, e in by_fp.items() if fp not in used]
    return new, matched, stale


def regenerate(findings: list[Finding], old_entries: list[dict]) -> list[dict]:
    """Entries for the current findings, keeping the reason of every entry
    whose fingerprint still matches; a new entry gets a placeholder reason
    a reviewer must replace."""
    old_by_fp = {entry_fingerprint(e): e for e in old_entries}
    out: dict[str, dict] = {}
    for f in findings:
        fp = f.fingerprint()
        if fp in out:
            continue
        old = old_by_fp.get(fp)
        out[fp] = {"check": f.check, "path": f.path, "context": f.context,
                   "line_text": f.line_text,
                   "reason": old["reason"] if old else _PLACEHOLDER_REASON}
    return list(out.values())


def default_baseline_path(repo_root: str) -> str:
    return os.path.join(repo_root, DEFAULT_RELPATH)


def find_reason(entries: list[dict], finding: Finding) -> Optional[str]:
    fp = finding.fingerprint()
    for e in entries:
        if entry_fingerprint(e) == fp:
            return e.get("reason")
    return None
