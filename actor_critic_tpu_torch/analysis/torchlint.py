"""torchlint: the port's static analyzer, over its own tree (the port's
counterpart of the JAX package's `scripts/jaxlint.py`).

    python -m actor_critic_tpu_torch.analysis.torchlint           # the default scan
    python -m actor_critic_tpu_torch.analysis.torchlint actor_critic_tpu_torch/algos
    python -m actor_critic_tpu_torch.analysis.torchlint --list-checks
    python -m actor_critic_tpu_torch.analysis.torchlint --select lock-discipline,check-then-act
    python -m actor_critic_tpu_torch.analysis.torchlint --diff HEAD    # changed files only
    python -m actor_critic_tpu_torch.analysis.torchlint --since HEAD~2 # + untracked files,
                                                                       # fixture-pair re-lint
    python -m actor_critic_tpu_torch.analysis.torchlint --json         # machine output
    python -m actor_critic_tpu_torch.analysis.torchlint --write-baseline  # regenerate
    python -m actor_critic_tpu_torch.analysis.torchlint --prune-stale     # drop dead entries
    python -m actor_critic_tpu_torch.analysis.torchlint --show-baselined  # audit accepted

The default scan is `actor_critic_tpu_torch/` and `chip_smoke.py`.

Exit codes:
    0  clean: zero un-baselined findings
    1  findings: at least one finding not covered by the baseline
    2  crash: parse error, unreadable path, malformed baseline, bad
       check name

`--error-on-new` names the default gate explicitly; it is always on.
Suppress one line in source with `# torchlint: disable=<check>[,<check>]`
(the why in the same comment); accept a finding for good by adding it to
`actor_critic_tpu_torch/analysis/torchlint_baseline.json` with a reason
(`--write-baseline` drafts entries; the reasons are written by hand).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_PATHS = ("actor_critic_tpu_torch", "chip_smoke.py")
FIXTURE_DIR = "tests/torch_lint_fixtures"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1].strip())
    p.add_argument(
        "paths", nargs="*", default=list(DEFAULT_PATHS),
        help=f"files/dirs to scan (default: {' '.join(DEFAULT_PATHS)})",
    )
    p.add_argument(
        "--list-checks", action="store_true",
        help="print the registered checks with one-line docs and exit 0",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable output",
    )
    p.add_argument(
        "--baseline", default=None,
        help="baseline file (default: <repo>/actor_critic_tpu_torch/analysis/"
        "torchlint_baseline.json)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every finding as new",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from the current findings (existing "
        "reasons are preserved; new entries get a NEEDS-REASON "
        "placeholder) and exit 0",
    )
    p.add_argument(
        "--show-baselined", action="store_true",
        help="also print baselined findings with their reasons",
    )
    p.add_argument(
        "--select", "--checks", dest="select", default=None,
        help="comma-separated subset of checks to run (e.g. "
        "--select lock-discipline,check-then-act; --checks is the "
        "original spelling, kept as an alias)",
    )
    p.add_argument(
        "--skip", default=None,
        help="comma-separated checks to skip (e.g. warmup-registry to "
        "stay fully import-free)",
    )
    p.add_argument(
        "--diff", metavar="REF", default=None,
        help="lint only .py files changed vs the given git ref (working "
        "tree vs REF, e.g. --diff HEAD or --diff main), "
        "intersected with the scanned paths — the pre-commit fast "
        "path: repo-scope checks see only the changed files, so the "
        "whole-repo model builds are skipped (cross-file findings may "
        "be missed; the full run stays the tier-1 gate). Exit codes "
        "unchanged; zero changed files is a clean exit 0",
    )
    p.add_argument(
        "--since", metavar="REV", default=None,
        help="like --diff, with the pre-commit ergonomics on top: REV "
        "is resolved through `git rev-parse` first (HEAD~2, branch "
        "names, tags — a typo'd rev is a clear exit-2 error, not an "
        "empty diff), untracked .py files count as changed (a "
        "brand-new module is linted before its first commit), and a "
        "change touching only a check's FIXTURE pair "
        "(tests/torch_lint_fixtures/<check>_{flag,ok}.py) re-lints the "
        "module implementing that check — editing the pinned contract "
        "re-examines the pass it pins",
    )
    p.add_argument(
        "--prune-stale", action="store_true",
        help="rewrite the baseline WITHOUT the stale entries this run "
        "can see (scanned paths × selected checks) and exit 0 — stale "
        "fingerprints otherwise linger as warnings forever",
    )
    p.add_argument(
        "--error-on-new", action="store_true",
        help="fail (exit 1) when un-baselined findings exist — the "
        "default, named explicitly for CI invocations",
    )
    args = p.parse_args(argv)

    from actor_critic_tpu_torch import analysis
    from actor_critic_tpu_torch.analysis import baseline, core

    if args.list_checks:
        checks = analysis.registered_checks()
        width = max(len(c.name) for c in checks)
        for c in checks:
            print(f"{c.name:<{width}}  {c.doc}")
        return 0

    if (args.write_baseline or args.prune_stale) and args.no_baseline:
        # --no-baseline empties the loaded entries, so combining it with
        # a baseline-rewriting mode would rewrite the file from nothing
        # — every audited reason silently destroyed. Refuse loudly.
        print(
            "torchlint: error: --write-baseline/--prune-stale cannot be "
            "combined with --no-baseline (it would discard every "
            "existing audited entry)",
            file=sys.stderr,
        )
        return 2

    checks = args.select.split(",") if args.select else None
    skip = args.skip.split(",") if args.skip else ()
    baseline_path = args.baseline or analysis.default_baseline_path(REPO)

    if args.diff is not None and args.since is not None:
        print(
            "torchlint: error: --diff and --since are the same fast path "
            "with different ergonomics — pass one",
            file=sys.stderr,
        )
        return 2

    paths = list(args.paths)
    ref = args.since if args.since is not None else args.diff
    if ref is not None:
        import subprocess

        flag = "--since" if args.since is not None else "--diff"
        if args.since is not None:
            # Resolve the rev up front: `git diff` against a typo'd rev
            # fails with the same message an empty tree would, so the
            # pre-commit path names the bad input explicitly.
            try:
                proc = subprocess.run(
                    ["git", "rev-parse", "--verify",
                     f"{ref}^{{commit}}"],
                    capture_output=True, text=True, cwd=REPO, check=True,
                )
                ref = proc.stdout.strip()
            except (OSError, subprocess.CalledProcessError) as e:
                detail = (getattr(e, "stderr", "") or str(e)).strip()
                print(
                    f"torchlint: error: --since {args.since}: not a "
                    f"resolvable rev ({detail.splitlines()[-1]})",
                    file=sys.stderr,
                )
                return 2
        try:
            proc = subprocess.run(
                ["git", "diff", "--name-only", ref, "--", "*.py"],
                capture_output=True, text=True, cwd=REPO, check=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            print(
                f"torchlint: error: {flag} {ref}: {detail.strip()}",
                file=sys.stderr,
            )
            return 2
        changed = {
            ln.strip() for ln in proc.stdout.splitlines() if ln.strip()
        }
        if args.since is not None:
            # Untracked modules are "changed vs REV" for pre-commit
            # purposes: a brand-new file must be linted before its
            # first commit, and `git diff REV` cannot see it.
            try:
                proc = subprocess.run(
                    ["git", "ls-files", "--others", "--exclude-standard",
                     "--", "*.py"],
                    capture_output=True, text=True, cwd=REPO, check=True,
                )
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                print(
                    f"torchlint: error: --since untracked scan: "
                    f"{detail.strip()}",
                    file=sys.stderr,
                )
                return 2
            changed |= {
                ln.strip() for ln in proc.stdout.splitlines() if ln.strip()
            }
            # Fixture-pair rule: the fixture files pin a check's
            # flag/ok contract, so a change touching ONLY
            # tests/torch_lint_fixtures/<check>_{flag,ok}.py re-lints the
            # module IMPLEMENTING that check — the pass and its pinned
            # contract are one unit of review.
            import re as _re

            fixture_re = _re.compile(
                rf"^{FIXTURE_DIR}/(.+)_(?:flag|ok)\.py$"
            )
            registry = {c.name: c for c in analysis.registered_checks()}
            for f in sorted(changed):
                m = fixture_re.match(f)
                if not m:
                    continue
                check = core.resolve_check_name(
                    m.group(1).replace("_", "-")
                )
                c = registry.get(check)
                if c is None:
                    continue  # a fixture with no registered pass
                mod_file = getattr(
                    sys.modules.get(c.fn.__module__), "__file__", None
                )
                if mod_file:
                    changed.add(
                        os.path.relpath(mod_file, REPO).replace(
                            os.sep, "/"
                        )
                    )
        # Intersect with the scan set: a changed file outside the
        # requested paths (tests, scripts) stays out, exactly as in a
        # full run over the same paths.
        try:
            scan_set = {
                os.path.relpath(p, REPO).replace(os.sep, "/")
                for p in core.iter_python_files(paths, REPO)
            }
        except analysis.AnalysisError as e:
            print(f"torchlint: error: {e}", file=sys.stderr)
            return 2
        paths = sorted(
            f for f in changed
            if f in scan_set and os.path.exists(os.path.join(REPO, f))
        )
        if not paths:
            print(
                f"torchlint: no scanned .py files changed vs "
                f"{args.since or args.diff} — nothing to lint"
            )
            return 0

    try:
        modules = analysis.load_modules(paths, REPO)
        findings = analysis.run_checks(modules, checks=checks, skip=skip)
        entries = (
            [] if args.no_baseline else analysis.load_baseline(baseline_path)
        )
    except analysis.AnalysisError as e:
        print(f"torchlint: error: {e}", file=sys.stderr)
        return 2

    scanned = {m.relpath for m in modules}
    # Alias-resolved, exactly as run_checks resolves them: `--skip
    # host-sync` must deselect transfer-discipline HERE too, or the
    # stale-scoping below would call its audited baseline entries
    # stale (and --prune-stale would delete them).
    resolve = core.resolve_check_name
    selected = (
        {resolve(c) for c in checks}
        if checks
        else {c.name for c in analysis.registered_checks()}
    )
    selected -= {resolve(c) for c in skip}

    if args.write_baseline:
        # A scoped run (path subset, --checks/--skip) regenerates only
        # what it could SEE; entries outside the scanned files or the
        # selected checks are retained verbatim, so a partial rewrite
        # can never silently delete another file's audited reasons.
        retained = [
            e
            for e in entries
            if e.get("path") not in scanned or e.get("check") not in selected
        ]
        entries_out = analysis.regenerate(findings, entries)
        have = {
            baseline.entry_fingerprint(e) for e in entries_out
        }
        entries_out += [
            e
            for e in retained
            if baseline.entry_fingerprint(e) not in have
        ]
        analysis.save_baseline(baseline_path, entries_out)
        placeholders = sum(
            1 for e in entries_out if str(e["reason"]).startswith("NEEDS-")
        )
        print(
            f"torchlint: wrote {len(entries_out)} baseline entr"
            f"{'y' if len(entries_out) == 1 else 'ies'} to {baseline_path}"
            + (
                f" — fill in {placeholders} NEEDS-REASON placeholder(s)"
                if placeholders
                else ""
            )
        )
        return 0

    new, matched, stale = analysis.apply_baseline(findings, entries)
    # Stale = "matches no finding" is only meaningful for files this
    # run actually scanned AND checks it actually ran; a path- or
    # check-subset run must not call the rest of the baseline stale.
    stale = [
        e
        for e in stale
        if e.get("path") in scanned and e.get("check") in selected
    ]

    if args.prune_stale:
        # Drop exactly the stale-in-scope entries; everything else
        # (matched entries, out-of-scope files/checks) is retained
        # verbatim — pruning is scoped the same way stale REPORTING is.
        drop = {baseline.entry_fingerprint(e) for e in stale}
        kept = [
            e
            for e in entries
            if baseline.entry_fingerprint(e) not in drop
        ]
        analysis.save_baseline(baseline_path, kept)
        print(
            f"torchlint: pruned {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'} "
            f"({len(kept)} kept) from {baseline_path}"
        )
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "new": [f.to_dict() for f in new],
                    "baselined": [
                        {**f.to_dict(), "reason": e.get("reason")}
                        for f, e in matched
                    ],
                    "stale_baseline_entries": stale,
                    "counts": {
                        "new": len(new),
                        "baselined": len(matched),
                        "stale": len(stale),
                    },
                },
                indent=2,
            )
        )
        return 1 if new else 0

    for f in new:
        print(f.render())
    if args.show_baselined:
        for f, e in matched:
            print(f"{f.render()}  [baselined: {e.get('reason')}]")
    for e in stale:
        print(
            "torchlint: warning: stale baseline entry "
            f"{baseline.entry_fingerprint(e)!r} matches no "
            "finding — remove it (or rerun --write-baseline)",
            file=sys.stderr,
        )
    summary = (
        f"torchlint: {len(new)} new finding(s), {len(matched)} baselined, "
        f"{len(stale)} stale baseline entr"
        f"{'y' if len(stale) == 1 else 'ies'}"
    )
    print(summary, file=sys.stderr if new else sys.stdout)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
