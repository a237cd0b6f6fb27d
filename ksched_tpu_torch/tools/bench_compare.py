"""The bench-trajectory ratchet: append runs, gate regressions.

The port of ksched_tpu's tools/bench_compare.py (:1-306), for the
records `python -m ksched_tpu_torch.bench` prints. A trajectory is a
JSONL latency history: one JSON line per bench run with the config,
platform, p50 and superstep detail. `append` folds a fresh bench record
(the JSON line the bench prints, or a suite artifact) into it; `gate`
fails when any series' NEWEST entry regressed more than the tolerance
against its PREVIOUS entry; `show` tabulates it. The trajectory is the
path given: this tool writes only there (the JAX package's
BENCH_TRAJECTORY.jsonl is its own history).

The gate ratchets two axes per series: wall-clock `p50_ms` and, for
entries that carry it (the churn/event-path series), `supersteps_p50`
with a relative tolerance plus a small absolute slack.

A series is (config, platform, mesh_devices): the platform is the
record's `backend=<path>/<platform>` suffix ("cuda" for the card, "cpu"
for --cpu runs; the JAX package's "tpu"), so a TPU history never serves
as a baseline for a card reading, nor a CPU reading for either; and
entries stamped `accelerator_unreachable` (the JAX bench's fallback,
which this port does not have) are never used as a baseline.

Usage:
    python -m ksched_tpu_torch.tools.bench_compare append TRAJ.jsonl \
        --from-bench out.json [--config NAME] [--note TEXT]
    python -m ksched_tpu_torch.tools.bench_compare gate TRAJ.jsonl [--tolerance 0.15]
    python -m ksched_tpu_torch.tools.bench_compare show TRAJ.jsonl
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

DEFAULT_TOLERANCE = 0.15
#: supersteps ratchet: relative tolerance + absolute slack (healthy
#: churn-series values are ~10; integer jitter of a few steps is
#: quantization, a jump past ~25% AND +8 is a warm-start regression)
SUPERSTEPS_TOLERANCE = 0.25
SUPERSTEPS_SLACK = 8

_stderr = functools.partial(print, file=sys.stderr)


def _git_commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _platform_of(record: dict) -> str:
    if record.get("accelerator_unreachable"):
        return "cpu-fallback"
    metric = record.get("metric", "")
    if "backend=" in metric:
        return metric.rsplit("/", 1)[-1].strip()
    return "unknown"


def entry_from_record(record: dict, config: Optional[str] = None,
                      note: Optional[str] = None) -> dict:
    """Normalize one bench JSON record into a trajectory entry."""
    detail = record.get("detail") or {}
    entry = {
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "commit": _git_commit(),
        "config": config or record.get("config") or "10kx1k",
        "platform": _platform_of(record),
        "metric": record.get("metric", ""),
        "p50_ms": record.get("value"),
        "vs_baseline": record.get("vs_baseline"),
    }
    for key in ("supersteps_p50", "supersteps_p99", "supersteps_max"):
        if key in detail:
            entry[key] = detail[key]
    # mesh shape: multi-chip readings are their own series — a 2-dev
    # CPU reading must never baseline (or gate) an 8-dev one, the same
    # isolation rule as cross-platform entries
    mesh = detail.get("mesh_devices", record.get("mesh_devices"))
    if mesh is not None:
        entry["mesh_devices"] = int(mesh)
    # the churn (round-pipeline) config: lift the arm comparison into
    # the series so the ratchet history shows WHERE the p50 comes from
    arms = detail.get("arms")
    if isinstance(arms, dict):
        dr = arms.get("device_resident") or {}
        fr = arms.get("full_rebuild") or {}
        if dr.get("supersteps_p50") is not None:
            entry["supersteps_p50"] = dr["supersteps_p50"]
        if dr.get("h2d_delta_bytes_per_round") is not None:
            entry["h2d_delta_bytes_per_round"] = dr["h2d_delta_bytes_per_round"]
        if fr.get("p50_ms") is not None:
            entry["full_rebuild_p50_ms"] = fr["p50_ms"]
        if "p50_improvement_vs_full_rebuild" in detail:
            entry["p50_improvement_vs_full_rebuild"] = detail[
                "p50_improvement_vs_full_rebuild"
            ]
    if record.get("accelerator_unreachable"):
        entry["accelerator_unreachable"] = True
    if note:
        entry["note"] = note
    return entry


def load_trajectory(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{i + 1}: bad JSON line: {e}")
    return out


def append_cmd(args, log=print, err=_stderr) -> int:
    with open(args.from_bench) as f:
        text = f.read().strip()
    # accept either a single JSON object or JSONL (take the last
    # bench record line, skipping suite provenance stamps)
    records = []
    try:
        doc = json.loads(text)
        records = [doc]
    except json.JSONDecodeError:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not rec.get("suite_stamp"):
                records.append(rec)
    if not records:
        raise SystemExit(f"no bench records in {args.from_bench}")
    wrote = 0
    with open(args.trajectory, "a") as f:
        for rec in records:
            if rec.get("value") is None:
                err(f"# skipping failed record: {rec.get('metric')}")
                continue
            entry = entry_from_record(rec, config=args.config, note=args.note)
            f.write(json.dumps(entry) + "\n")
            wrote += 1
    log(f"appended {wrote} entr{'y' if wrote == 1 else 'ies'} to "
        f"{args.trajectory}")
    return 0


def _series_key(entry: dict):
    # mesh shape (device count) is part of the series identity: sharded
    # readings taken on different mesh sizes are different experiments
    # (single-chip entries carry no mesh field and keep their series)
    return (
        entry.get("config"), entry.get("platform"), entry.get("mesh_devices")
    )


def gate_cmd(args, log=print, err=_stderr) -> int:
    entries = load_trajectory(args.trajectory)
    if not entries:
        raise SystemExit(f"{args.trajectory} is empty; nothing to gate")
    series = {}
    for e in entries:
        if e.get("p50_ms") is None:
            continue
        series.setdefault(_series_key(e), []).append(e)
    failures = []
    checked = 0
    for (config, platform, mesh), es in sorted(
        series.items(),
        key=lambda kv: (
            str(kv[0][0]), str(kv[0][1]),
            -1 if kv[0][2] is None else int(kv[0][2]),
        ),
    ):
        if len(es) < 2:
            continue
        prev, last = es[-2], es[-1]
        # a cpu-fallback reading must not gate (or baseline) a device
        # series; same-platform by key, but double-check the stamp
        if prev.get("accelerator_unreachable") != last.get(
            "accelerator_unreachable"
        ):
            continue
        checked += 1
        p_prev, p_last = float(prev["p50_ms"]), float(last["p50_ms"])
        ratio = (p_last - p_prev) / max(p_prev, 1e-9)
        tag = f"{config} [{platform}]" + (
            f" [{mesh}dev]" if mesh is not None else ""
        )
        verdict = "OK" if ratio <= args.tolerance else "REGRESSED"
        log(
            f"{tag:<40} p50 {p_prev:9.3f} -> {p_last:9.3f} ms "
            f"({ratio:+8.1%})  {verdict}"
        )
        if ratio > args.tolerance:
            failures.append(
                f"{tag}: p50 {p_prev:.3f} -> {p_last:.3f} ms "
                f"(+{ratio:.1%} > {args.tolerance:.0%} tolerance; "
                f"{prev.get('commit')} -> {last.get('commit')})"
            )
        # supersteps ratchet: only when BOTH entries carry the field
        # (the churn/event-path series); regression requires blowing
        # the relative tolerance AND the absolute slack
        if prev.get("supersteps_p50") is not None and last.get(
            "supersteps_p50"
        ) is not None:
            s_prev = float(prev["supersteps_p50"])
            s_last = float(last["supersteps_p50"])
            s_ratio = (s_last - s_prev) / max(s_prev, 1e-9)
            bad = (
                s_ratio > args.supersteps_tolerance
                and s_last - s_prev > SUPERSTEPS_SLACK
            )
            log(
                f"{tag:<40} ss  {s_prev:9.0f} -> {s_last:9.0f}    "
                f"({s_ratio:+8.1%})  {'REGRESSED' if bad else 'OK'}"
            )
            if bad:
                failures.append(
                    f"{tag}: supersteps_p50 {s_prev:.0f} -> {s_last:.0f} "
                    f"(+{s_ratio:.1%} > {args.supersteps_tolerance:.0%} "
                    f"tolerance and +{s_last - s_prev:.0f} > "
                    f"{SUPERSTEPS_SLACK} slack; warm-start price war "
                    f"creeping back? {prev.get('commit')} -> "
                    f"{last.get('commit')})"
                )
    if not checked:
        log("gate: no series has two comparable entries yet (pass)")
        return 0
    if failures:
        err("\nBENCH GATE FAILED:")
        for f_ in failures:
            err(f"  {f_}")
        return 1
    log(f"bench gate OK: {checked} series within "
        f"{args.tolerance:.0%} of their previous entry")
    return 0


def show_cmd(args, log=print, err=_stderr) -> int:
    entries = load_trajectory(args.trajectory)
    log(f"{'utc':<22} {'commit':<9} {'config':<22} {'platform':<13} "
        f"{'p50_ms':>9} {'ss_p50':>7}")
    for e in entries:
        p50 = e.get("p50_ms")
        p50_s = f"{p50:>9.3f}" if p50 is not None else f"{'—':>9}"
        log(
            f"{e.get('utc', ''):<22} {e.get('commit', ''):<9} "
            f"{e.get('config', ''):<22} {e.get('platform', ''):<13} "
            f"{p50_s} {e.get('supersteps_p50', ''):>7}"
        )
    return 0


def main(argv=None, log=print, err=_stderr) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.bench_compare",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_append = sub.add_parser("append", help="fold a bench record in")
    ap_append.add_argument("trajectory")
    ap_append.add_argument("--from-bench", required=True,
                           help="the bench's output JSON (line or artifact)")
    ap_append.add_argument("--config", default=None,
                           help="override the config name")
    ap_append.add_argument("--note", default=None)
    ap_append.set_defaults(fn=append_cmd)
    ap_gate = sub.add_parser("gate", help="fail on p50 regression")
    ap_gate.add_argument("trajectory")
    ap_gate.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                         help="max allowed relative p50 increase "
                         "(default 0.15)")
    ap_gate.add_argument("--supersteps-tolerance", type=float,
                         default=SUPERSTEPS_TOLERANCE,
                         help="max allowed relative supersteps_p50 "
                         "increase for series that carry it "
                         "(default 0.25; +8 absolute slack)")
    ap_gate.set_defaults(fn=gate_cmd)
    ap_show = sub.add_parser("show", help="tabulate the trajectory")
    ap_show.add_argument("trajectory")
    ap_show.set_defaults(fn=show_cmd)
    args = ap.parse_args(argv)
    return args.fn(args, log, err)


if __name__ == "__main__":
    sys.exit(main())
