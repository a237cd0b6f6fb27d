"""Render an observability dump as a phase-percentile table.

One reader for every artifact the port's obs subsystem writes, detected
by shape: point it at whichever file a run left behind.

- **RoundRecord JSONL** (runtime/trace.py `RoundTracer.dump`, the CLI's
  `--round-trace`): exact per-phase percentiles over the recorded rounds
  (idle sweeps excluded and counted apart), and the per-tenant view when
  the records carry a multi-tenant service's `tenant`;
- **registry snapshot JSON** (obs/exporter.py `dump_registry`,
  `--obs-dump`/`--obs-out`, or the live `/varz` body): percentiles
  *estimated* from the `ksched_round_phase_ms` histogram buckets
  (linear interpolation within a bucket), and a counter table;
- **flight-recorder dump** (obs/flight.py, `flight_<reason>_r*.json`):
  the ring's embedded RoundRecords as for JSONL, the embedded
  `solver_stalls` (structured stall reasons with their telemetry tails,
  as convergence tables) and the pipeline occupancy of its span slices;
- **Chrome trace JSON** (obs/spans.py `SpanTracer.dump`, `--trace-out`):
  per-span-name duration percentiles over the trace events, and the
  double-buffered loop's pipeline occupancy;
- **solver telemetry JSON** (obs/soltel.py `SolveTelemetry.to_dict()`,
  or tools/superstep_trace.py `--out`): the per-superstep convergence
  table (eps, active, excess, pushes, relabels, saturated arcs, work).

Port of ksched_tpu's tools/obs_report.py: the same tables, line for
line, on the same artifact. Host only: it needs no card.

Usage: python -m ksched_tpu_torch.tools.obs_report DUMP [--phase-metric NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

PCTS = (50, 90, 99)


def _row(name: str, vals) -> str:
    v = np.asarray(vals, dtype=np.float64)
    cells = [f"{np.percentile(v, p):10.3f}" for p in PCTS]
    return (
        f"{name:<24} {len(v):>7} " + " ".join(cells)
        + f" {v.mean():10.3f} {v.max():10.3f}"
    )


def _header(unit: str = "ms") -> str:
    cols = [f"p{p}_{unit}" for p in PCTS] + [f"mean_{unit}", f"max_{unit}"]
    return f"{'phase':<24} {'n':>7} " + " ".join(f"{c:>10}" for c in cols)


def report_records(records: list, log=print) -> None:
    """Exact percentiles from RoundRecord dicts (JSONL / flight ring)."""
    def is_idle(r):
        return r.get("solver_rung", 0) == -1 and not r.get("noop_round")

    idle = [r for r in records if is_idle(r)]
    active = [r for r in records if not is_idle(r)]
    log(f"rounds: {len(active)} (+{len(idle)} idle sweeps excluded)")
    noops = sum(1 for r in active if r.get("noop_round"))
    misses = sum(1 for r in active if r.get("deadline_miss"))
    if noops or misses:
        log(f"noop_rounds: {noops}  deadline_misses: {misses}")
    faults: dict = {}
    for r in records:
        for k, v in (r.get("faults_injected") or {}).items():
            faults[k] = faults.get(k, 0) + v
    if faults:
        log(f"faults: {dict(sorted(faults.items()))}")
    if not active:
        return
    phases = sorted({p for r in active for p in r.get("phases_ms", {})})
    log(_header())
    for phase in phases:
        log(_row(phase, [r["phases_ms"].get(phase, 0.0) for r in active]))
    _report_tenants(active, log)


def _report_tenants(active: list, log=print) -> None:
    """Per-tenant percentile view: when the records carry a multi-
    tenant service's ``tenant`` field, break the total-phase
    percentiles (plus fault/NOOP attribution) out per cell — the
    operator's one-glance check that a pathological tenant degraded
    only its own lane."""
    tenants = sorted({r.get("tenant") or "" for r in active})
    if tenants == [""]:
        return
    log("\nper-tenant (total phase):")
    log(_header())
    for tid in tenants:
        rows = [r for r in active if (r.get("tenant") or "") == tid]
        label = tid or "<untagged>"
        suffix = []
        noops = sum(1 for r in rows if r.get("noop_round"))
        faults = sum(
            sum((r.get("faults_injected") or {}).values()) for r in rows
        )
        degr = sum(r.get("degradations", 0) for r in rows)
        if faults or degr or noops:
            suffix.append(f"  [faults={faults} degr={degr} noop={noops}]")
        log(
            _row(label, [r["phases_ms"].get("total", 0.0) for r in rows])
            + "".join(suffix)
        )


def _hist_percentile(buckets: list, count: int, pct: float) -> float:
    """Estimate a percentile from cumulative-ready [bound, n] bucket
    pairs (n per-bucket, +Inf last) by interpolating within the
    landing bucket. Standard Prometheus-style estimation: exact at
    bucket bounds, log-linear inside."""
    want = count * pct / 100.0
    cum = 0.0
    lo = 0.0
    for bound, n in buckets:
        prev = cum
        cum += n
        if cum >= want and n > 0:
            if bound == "+Inf":
                return float(lo)
            b = float(bound)
            frac = (want - prev) / n
            return float(lo + (b - lo) * frac)
        if bound != "+Inf":
            lo = float(bound)
    return float(lo)


def report_snapshot(metrics: dict, phase_metric: str = "ksched_round_phase_ms",
                    log=print) -> None:
    """Histogram-estimated percentiles + counters from a registry
    snapshot (`dump_registry` / the live `/varz` body)."""
    fam = metrics.get(phase_metric)
    if fam and fam.get("kind") == "histogram":
        log(f"{phase_metric} (histogram-estimated):")
        log(_header())
        for sample in fam["samples"]:
            name = ",".join(f"{k}={v}" for k, v in sorted(sample["labels"].items()))
            count = sample["count"]
            if not count:
                continue
            cells = [
                f"{_hist_percentile(sample['buckets'], count, p):10.3f}"
                for p in PCTS
            ]
            mean = sample["sum"] / count
            log(
                f"{name or '(all)':<24} {count:>7} " + " ".join(cells)
                + f" {mean:10.3f} {'':>10}"
            )
        log()
    log(f"{'counter/gauge':<44} {'value':>14}")
    for name, fam in sorted(metrics.items()):
        if fam.get("kind") == "histogram":
            continue
        for sample in fam["samples"]:
            lbl = ",".join(f"{k}={v}" for k, v in sorted(sample["labels"].items()))
            series = name + (f"{{{lbl}}}" if lbl else "")
            log(f"{series:<44} {sample['value']:>14g}")


def report_convergence(tel: dict, max_rows: int = 0, log=print) -> None:
    """Per-superstep convergence table from a `solver_telemetry` dict
    (obs/soltel.SolveTelemetry.to_dict(), or a stall event's
    `telemetry_tail` re-wrapped). THE one renderer for solver-interior
    rows: tools/superstep_trace.py and the flight-dump view call it."""
    cols = tel.get("cols") or ["eps", "active", "excess", "pushed",
                               "relabels", "saturated", "work"]
    rows = tel.get("rows") or []
    start = int(tel.get("start_step", 0))
    head = f"solver telemetry: backend={tel.get('backend', '?')} "
    if "steps" in tel:
        head += f"steps={tel['steps']}"
        if tel.get("budget"):
            head += f"/{tel['budget']} budget"
    if tel.get("truncated"):
        head += (f" TRUNCATED (ring kept the final {len(rows)} of "
                 f"{tel.get('steps', '?')} supersteps)")
    if "converged" in tel:
        head += "" if tel["converged"] else "  NOT CONVERGED"
    log(head)
    if not rows:
        log("  (no supersteps recorded)")
        return
    shown = rows if not max_rows else rows[-max_rows:]
    offset = start + (len(rows) - len(shown))
    width = max(len(c) for c in cols) + 2
    log(f"{'step':>8} " + " ".join(f"{c:>{width}}" for c in cols))
    for i, row in enumerate(shown):
        log(
            f"{offset + i:>8} "
            + " ".join(f"{int(v):>{width}}" for v in row[: len(cols)])
        )
    # phase summary: supersteps per eps value, in order
    phases = []
    for row in rows:
        e = int(row[0])
        if phases and phases[-1][0] == e:
            phases[-1][1] += 1
        else:
            phases.append([e, 1])
    if len(phases) > 1:
        log("phases: " + "  ".join(f"eps={e}: {k}" for e, k in phases))


def report_stalls(stalls: list, log=print) -> None:
    """Structured solver stall events (a flight dump's
    `solver_stalls`), each with its telemetry-tail convergence table."""
    log(f"solver stalls: {len(stalls)} event(s)")
    for i, ev in enumerate(stalls):
        line = (f"  [{i}] kind={ev.get('kind')} rung={ev.get('rung', '-')} "
                f"backend={ev.get('backend', '-')} "
                f"supersteps={ev.get('supersteps', '-')}")
        log(line)
        if ev.get("detail") or ev.get("error"):
            log(f"      {ev.get('detail') or ev.get('error')}")
        tail = ev.get("telemetry_tail")
        if tail:
            report_convergence(
                {
                    "cols": ev.get("telemetry_cols"),
                    "rows": tail,
                    "start_step": ev.get("telemetry_start_step", 0),
                    "backend": ev.get("backend", "?"),
                    "truncated": ev.get("telemetry_truncated", False),
                },
                log=log,
            )


def report_trace(events: list, log=print) -> None:
    """Per-span-name duration percentiles from Chrome trace events."""
    by_name: dict = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_name.setdefault(ev["name"], []).append(ev.get("dur", 0.0) / 1e3)
    log(f"trace: {len(events)} events, {len(by_name)} span names")
    log(_header())
    for name in sorted(by_name):
        log(_row(name, by_name[name]))
    report_pipeline_occupancy(events, log)


#: host-side span names whose time inside a round's in-flight window
#: counts as overlapped work (the POSTs the pipelined loop defers into
#: the dispatch window, and the decode when a driver interleaves it)
OVERLAP_SPAN_NAMES = ("bindings_post", "decode", "deltas", "apply")


def pipeline_occupancy(events: list) -> Optional[dict]:
    """Measure the double-buffered loop's overlap from a span trace:
    for every round with a ``solve_dispatch`` → ``solve_sync`` pair,
    the in-flight window is the gap between dispatch end and sync
    start (the device is crunching); host spans (OVERLAP_SPAN_NAMES)
    falling inside that window are work the pipeline hid behind the
    solve. Returns None when the trace carries no pipelined rounds
    (nothing dispatched asynchronously)."""
    complete = [ev for ev in events if ev.get("ph") == "X"]
    rounds = [ev for ev in complete if ev["name"] in ("service_round", "round")]
    # prefer service_round (it contains the POST flush); fall back to
    # bare scheduler rounds for driver-level traces
    if any(ev["name"] == "service_round" for ev in rounds):
        rounds = [ev for ev in rounds if ev["name"] == "service_round"]
    dispatches = [ev for ev in complete if ev["name"] == "solve_dispatch"]
    syncs = [ev for ev in complete if ev["name"] == "solve_sync"]
    hosts = [ev for ev in complete if ev["name"] in OVERLAP_SPAN_NAMES]
    if not rounds or not dispatches or not syncs:
        return None
    total_round_us = 0.0
    total_window_us = 0.0
    total_overlap_us = 0.0
    windows = 0
    for rnd in rounds:
        r0, r1 = rnd["ts"], rnd["ts"] + rnd.get("dur", 0.0)

        def inside(ev):
            return ev["ts"] >= r0 and ev["ts"] + ev.get("dur", 0.0) <= r1

        ds = [ev for ev in dispatches if inside(ev)]
        ss = [ev for ev in syncs if inside(ev)]
        if not ds or not ss:
            continue
        w0 = min(ev["ts"] + ev.get("dur", 0.0) for ev in ds)
        w1 = max(ev["ts"] for ev in ss)
        if w1 <= w0:
            continue
        overlap = 0.0
        for ev in hosts:
            h0, h1 = ev["ts"], ev["ts"] + ev.get("dur", 0.0)
            overlap += max(0.0, min(h1, w1) - max(h0, w0))
        total_round_us += r1 - r0
        total_window_us += w1 - w0
        total_overlap_us += overlap
        windows += 1
    if not windows:
        return None
    return {
        "rounds_with_window": windows,
        "round_wall_ms": total_round_us / 1e3,
        "inflight_window_ms": total_window_us / 1e3,
        "overlapped_host_ms": total_overlap_us / 1e3,
        # the headline: fraction of round wall where upload/solve
        # overlapped decode/bind work on the host
        "occupancy_of_round": (
            total_overlap_us / total_round_us if total_round_us else 0.0
        ),
        "occupancy_of_window": (
            total_overlap_us / total_window_us if total_window_us else 0.0
        ),
    }


def report_pipeline_occupancy(events: list, log=print) -> None:
    occ = pipeline_occupancy(events)
    if occ is None:
        return
    log()
    log(
        f"pipeline occupancy: {occ['rounds_with_window']} round(s) with an "
        f"in-flight solve window"
    )
    log(
        f"  round wall {occ['round_wall_ms']:.2f} ms, in-flight window "
        f"{occ['inflight_window_ms']:.2f} ms, overlapped host work "
        f"{occ['overlapped_host_ms']:.2f} ms"
    )
    log(
        f"  {occ['occupancy_of_round']:.1%} of round wall overlapped the "
        f"solve ({occ['occupancy_of_window']:.1%} of the in-flight window)"
    )


def load_and_report(path: str, phase_metric: str = "ksched_round_phase_ms",
                    log=print) -> None:
    with open(path) as f:
        text = f.read()
    if not text.strip():
        log("empty dump", file=sys.stderr)
        return
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None  # multi-line JSONL: one record per line
    if isinstance(doc, dict):
        if "solver_telemetry" in doc:
            report_convergence(doc["solver_telemetry"], log=log)
            return
        if "cols" in doc and "rows" in doc:
            report_convergence(doc, log=log)  # bare SolveTelemetry.to_dict()
            return
        if "metrics" in doc:
            report_snapshot(doc["metrics"], phase_metric, log)
            return
        if "rounds" in doc and isinstance(doc["rounds"], list):
            log(f"flight dump: reason={doc.get('reason')} "
                f"rounds_seen={doc.get('rounds_seen')}")
            report_records([entry["record"] for entry in doc["rounds"]], log)
            if doc.get("solver_stalls"):
                log()
                report_stalls(doc["solver_stalls"], log)
            # the ring's span slices double as a trace: surface the
            # double-buffered loop's overlap from any flight dump
            report_pipeline_occupancy(
                [ev for entry in doc["rounds"] for ev in entry.get("spans", [])], log
            )
            return
        if "traceEvents" in doc:
            report_trace(doc["traceEvents"], log)
            return
        if doc and all(isinstance(v, dict) and "kind" in v for v in doc.values()):
            report_snapshot(doc, phase_metric, log)  # bare /varz body
            return
    # fall through: RoundRecord JSONL
    records = [json.loads(line) for line in text.splitlines() if line.strip()]
    report_records(records, log)


def main(argv=None, log=print) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ksched_tpu_torch.tools.obs_report",
        description="phase-percentile table from any obs dump",
    )
    ap.add_argument("dump", help="JSONL round trace, registry snapshot, "
                    "flight dump, Chrome trace or solver telemetry JSON")
    ap.add_argument("--phase-metric", default="ksched_round_phase_ms",
                    help="histogram family to tabulate from snapshots")
    args = ap.parse_args(argv)
    try:
        load_and_report(args.dump, args.phase_metric, log)
    except BrokenPipeError:
        # piping into head or a pager closes stdout mid-table: point the
        # fd at devnull so the interpreter's exit flush does not re-raise
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
