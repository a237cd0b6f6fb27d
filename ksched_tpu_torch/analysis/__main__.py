"""kschedlint-torch: the port's lint CLI (Levels 1 and 3 of ksched_tpu_torch.analysis).

Usage, from the repo root:
    python -m ksched_tpu_torch.analysis
    python -m ksched_tpu_torch.analysis --coverage
    python -m ksched_tpu_torch.analysis --rules dtype64,unregistered-program ksched_tpu_torch
    python -m ksched_tpu_torch.analysis --json
    python -m ksched_tpu_torch.analysis --prune-baseline

`paths` default to `ksched_tpu_torch chip_smoke.py`, resolved against
`--root` (the checkout this package sits in).

Exit status: 0 when every violation is suppressed inline or recorded in
the baseline AND the baseline carries no stale entries; 1 when NEW
violations exist (printed one per line as `path:line:col: rule:
message`), when baseline entries match no current violation (the ratchet
only shrinks — run --prune-baseline to shed fixed debt), or when
--coverage finds a hole; 2 on usage errors, including unknown rule names
in --rules.

--coverage adds the Level-3 program-coverage report: every kernel
launch, collective call and annotated program def in library code is
annotated with a registered `# kschedlint: program=<name>` or waived
with `# kschedlint: disable=unregistered-program -- rationale`, and
every registered site name is annotated somewhere. The summary line is
printed either way.

The op-trace contracts and the registry engine (the dynamic checks)
need torch and run in tests/test_torch_program_registry.py and the
smoke's `analysis` phase, not here: this CLI and the registry it reads
are stdlib-only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

from .ast_rules import RULES, lint_paths, program_coverage
from .baseline import load_baseline, split_by_baseline, write_baseline
from .program_registry import PROGRAMS

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_BASELINE = os.path.join("ksched_tpu_torch", "analysis", "baseline.json")
DEFAULT_PATHS = ["ksched_tpu_torch", "chip_smoke.py"]


def coverage_summary(cov) -> str:
    return (
        f"kschedlint-torch L3: {len(PROGRAMS)} programs registered / "
        f"{cov['sites']} call sites swept / "
        f"{len(cov['waived'])} waived / "
        f"{len(cov['unaudited'])} unaudited"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kschedlint-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                        help="files/directories to lint (default: the port and "
                        "chip_smoke.py)")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline JSON (repo-relative)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: every violation fails")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept current violations into the baseline and exit 0")
    parser.add_argument("--prune-baseline", action="store_true",
                        help="shed stale baseline entries (shrink-only: never "
                        "adds debt) and exit 0 if nothing new")
    parser.add_argument("--rules", default=None, metavar="R1,R2",
                        help="run only these rules (unknown names exit 2)")
    parser.add_argument("--coverage", action="store_true",
                        help="also run the Level-3 program-coverage report; "
                        "unaudited sites or unannotated registered programs fail")
    parser.add_argument("--json", dest="as_json", action="store_true",
                        help="emit one machine-readable JSON object on stdout")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--root", default=_REPO_ROOT,
                        help="repo root paths are resolved against")
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, fn in RULES.items():
            doc = (fn.__doc__ or "").strip().split("\n")[0]
            print(f"{name:22s} {doc}")
        return 0

    rules = None
    if args.rules is not None:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown or not rules:
            print(f"kschedlint-torch: unknown rule(s) in --rules: "
                  f"{unknown or '(none given)'} (known: {', '.join(RULES)})",
                  file=sys.stderr)
            return 2

    for p in args.paths:
        # os.path.join passes an absolute p through untouched, so a typo'd
        # absolute path is rejected too instead of linting zero files
        if not os.path.exists(os.path.join(args.root, p)):
            print(f"kschedlint-torch: no such path: {p}", file=sys.stderr)
            return 2

    violations = lint_paths(args.paths, repo_root=args.root, rules=rules)
    baseline_path = os.path.join(args.root, args.baseline)

    if args.write_baseline:
        count = write_baseline(baseline_path, violations)
        print(f"kschedlint-torch: baseline written with {count} "
              f"entr{'y' if count == 1 else 'ies'}")
        return 0

    baseline = Counter() if args.no_baseline else load_baseline(baseline_path)
    new, old, stale = split_by_baseline(violations, baseline)

    if args.prune_baseline:
        # shrink-only: keep exactly the entries current violations still
        # consume; NEVER admits new debt (that is --write-baseline)
        write_baseline(baseline_path, old)
        stale = Counter()

    cov = None
    coverage_problems = []
    if args.coverage:
        cov = program_coverage(args.paths, repo_root=args.root)
        for entry in cov["unaudited"]:
            coverage_problems.append(
                f"{entry['path']}:{entry['line']}: unaudited program site "
                f"`{entry['callee']}` ({entry['kind']})"
            )
        for name in cov["unannotated_registered"]:
            coverage_problems.append(
                f"registry: program site `{name}` is registered but annotated "
                "at no site — annotate it or drop the spec"
            )

    if args.as_json:
        payload = {
            "new": [
                {"path": v.path, "line": v.line, "col": v.col,
                 "rule": v.rule, "message": v.message}
                for v in new
            ],
            "baselined": len(old),
            "stale_baseline": [
                {"path": p, "rule": r, "hash": h, "count": c}
                for (p, r, h), c in sorted(stale.items())
            ],
            "rules": list(RULES if rules is None else rules),
        }
        if cov is not None:
            payload["coverage"] = {
                "programs_registered": len(PROGRAMS),
                "sites": cov["sites"],
                "annotated": cov["annotated"],
                "waived": cov["waived"],
                "unaudited": cov["unaudited"],
                "unannotated_registered": cov["unannotated_registered"],
                "summary": coverage_summary(cov),
            }
        payload["ok"] = not (new or stale or coverage_problems)
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0 if payload["ok"] else 1

    for v in new:
        print(v.render())
    for line in coverage_problems:
        print(line)
    if old:
        print(f"kschedlint-torch: {len(old)} baselined violation(s) not shown "
              f"(ratchet debt in {args.baseline})", file=sys.stderr)
    if stale:
        print(f"kschedlint-torch: {sum(stale.values())} stale baseline entr(y/ies) — "
              "the violations were fixed; run --prune-baseline to shed them",
              file=sys.stderr)
    if cov is not None:
        print(coverage_summary(cov))
    if new or stale or coverage_problems:
        problems = len(new) + sum(stale.values()) + len(coverage_problems)
        print(f"kschedlint-torch: {problems} problem(s)", file=sys.stderr)
        return 1
    print(f"kschedlint-torch: clean ({len(old)} baselined, "
          f"{len(list(RULES if rules is None else rules))} rules)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
