"""Checked-in lint baseline: only NEW violations fail the gate.

The baseline (ksched_tpu_torch/analysis/baseline.json) records fingerprints of
violations that were reviewed and accepted when the suite landed, so
the gate ratchets: existing debt is visible but non-blocking, anything
new fails CI. The repo's baseline is kept EMPTY — every violation the
suite surfaced was fixed or suppressed inline with a rationale — and
the mechanism exists so a future emergency landing can ratchet instead
of blocking.

Fingerprints are (path, rule, hash of the stripped line text), so
they survive unrelated edits moving a line, but an edit to the
offending line itself re-fires the rule (the right behavior: the line
was re-touched, re-justify it). The baseline is a MULTISET: one entry
waives one occurrence, so copy-pasting a baselined bad line elsewhere
in the same file still fails the gate.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from .ast_rules import Violation

_Key = Tuple[str, str, str]


def fingerprint(v: Violation) -> Dict[str, str]:
    digest = hashlib.sha1(
        f"{v.path}:{v.rule}:{v.line_text.strip()}".encode()
    ).hexdigest()[:16]
    return {"path": v.path, "rule": v.rule, "hash": digest}


def _key(entry: Dict[str, str]) -> _Key:
    return (entry["path"], entry["rule"], entry["hash"])


def load_baseline(path: str) -> Counter:
    """Multiset of accepted fingerprints (repeats waive repeats)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return Counter()
    entries = data.get("violations", []) if isinstance(data, dict) else data
    return Counter(_key(e) for e in entries)


def write_baseline(path: str, violations: Iterable[Violation]) -> int:
    # one entry per occurrence (NOT deduplicated): the gate matches
    # entries to occurrences one-for-one
    entries = sorted(tuple(fingerprint(v).items()) for v in violations)
    payload = {
        "comment": "kschedlint ratchet: reviewed pre-existing violations. "
        "Keep empty; see ksched_tpu_torch/analysis/__init__.py.",
        "violations": [dict(e) for e in entries],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(payload["violations"])


def split_by_baseline(
    violations: Iterable[Violation], baseline: Counter
) -> Tuple[List[Violation], List[Violation], Counter]:
    """(new, baselined, stale) — stale is the multiset of baseline
    entries no current violation consumed (fixed debt; shed them with
    --write-baseline)."""
    remaining = Counter(baseline)
    new: List[Violation] = []
    old: List[Violation] = []
    for v in violations:
        key = _key(fingerprint(v))
        if remaining[key] > 0:
            remaining[key] -= 1
            old.append(v)
        else:
            new.append(v)
    return new, old, +remaining
