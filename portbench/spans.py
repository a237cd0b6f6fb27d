"""The program's own spans and counters in a run of a cell.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> \
        [--profile 1] [--out chiprun_out/spans.jsonl]

One run of the cell as `portbench.run` makes it (with `--profile 1` its
`--trace 1` run, the profiler capturing the window), with a `SpanTracer`
(`ksched_tpu_torch/obs/spans.py`) installed before the system is built.
The program then records its spans on the host clock and, while the
profiler records, as profiler ranges under the same names on the
capture's clock. The window is marked in the tracer's ring where the
harness reads the program's host reads (`harness.host_reads`, at the
window's two ends), and the registry's counters are read there too.

The readers below take the harness's ctx with these keys added:
`spans` (the ring's events inside the window, None when the ring
dropped any), `setup_spans` (those before it), `counters` (each counter
sample's change over the window, by name and labels) and, from the
capture, `idle_by_span`. Per run, one JSON line: the run's result line,
the six readers' values (`READERS`), each phase's self time a round,
the rounds grouped by their solve's attempts, the solve counters' window
deltas,
the card's idle time and the kernel launches by the innermost program
span open at the time (`outside` = the caller's code between rounds),
and `ranges_check`: the capture reduced by `portbench/trace.py` with
the program's ranges in it and with them taken out.

`portbench.run` installs no tracer, so its runs record nothing and
these readers are not among its metrics.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

#: where no program span is open
OUTSIDE = "outside"
#: the tracer's ring: a 30 s run records ~50,000 spans
RING = 1 << 22


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def _tree(events):
    """{span id: event} of a list of the tracer's Chrome events."""
    return {e["args"]["sid"]: e for e in events if "sid" in e["args"]}


def _round_of(e, by_sid):
    """The `round` span an event lies under (itself if it is one), or
    None."""
    while e is not None:
        if e["name"] == "round":
            return e
        e = by_sid.get(e["args"].get("parent_sid"))
    return None


def _per_round(ctx, name):
    """(rounds, {round sid: summed microseconds of its `name` spans}),
    or None without spans or rounds."""
    events = ctx.get("spans")
    if not events:
        return None
    by_sid = _tree(events)
    rounds = {e["args"]["sid"]: e for e in events if e["name"] == "round"}
    if not rounds:
        return None
    got = dict.fromkeys(rounds, 0.0)
    for e in events:
        if e["name"] == name:
            r = _round_of(e, by_sid)
            if r is not None and r["args"]["sid"] in got:
                got[r["args"]["sid"]] += e["dur"]
    return rounds, got


def round_issue_ms(ctx):
    """Mean per round of the `round` span less its `read` spans: the
    host's time issuing the round (ms)."""
    got = _per_round(ctx, "read")
    if got is None:
        return None
    rounds, reads = got
    return sum(rounds[k]["dur"] - reads[k] for k in rounds) / len(rounds) / 1e3


def read_wait_ms(ctx):
    """Mean per round of its `read` spans: the host blocked on the card
    (ms)."""
    got = _per_round(ctx, "read")
    if got is None:
        return None
    rounds, reads = got
    return sum(reads.values()) / len(rounds) / 1e3


def idle_in_round_pct(ctx):
    """The share of the card's idle time in the window that lies inside
    the program's `round` ranges; the rest is the caller's, between
    rounds (%)."""
    idle = ctx.get("idle_by_span")
    if not idle or not idle["idle_s"]:
        return None
    return 100.0 * idle["in_round_s"] / idle["idle_s"]


def wasted_supersteps_pct(ctx):
    """The window's discarded attempts' supersteps
    (`ksched_device_discarded_supersteps_total`) over its rounds'
    summed `supersteps` stat (%)."""
    counters, counts = ctx.get("counters"), ctx.get("counts")
    if counters is None or counts is None:
        return None
    total = int(counts["supersteps"].sum())
    wasted = sum(v for (name, _labels), v in counters.items()
                 if name == "ksched_device_discarded_supersteps_total")
    return 100.0 * wasted / total if total else None


def group_table_sync_ms(ctx):
    """Mean per upkeep of the program's `group_table` and `fetch_state`
    spans outside any round: the Quincy table's upkeep, without the
    caller's own work between them (ms). An upkeep is what lies between
    two rounds."""
    events = ctx.get("spans")
    if not events:
        return None
    upkeeps, cur = [], 0.0
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["name"] == "round":
            if cur:
                upkeeps.append(cur)
            cur = 0.0
        elif e["name"] in ("group_table", "fetch_state") and "parent_sid" not in e["args"]:
            cur += e["dur"]
    if cur:
        upkeeps.append(cur)
    return sum(upkeeps) / len(upkeeps) / 1e3 if upkeeps else None


def stage_windows_s(ctx):
    """The `stage.windows` span of set-up: the stager's window loop and
    its live-bitmap mirror (s)."""
    events = ctx.get("setup_spans")
    if not events:
        return None
    got = [e["dur"] for e in events if e["name"] == "stage.windows"]
    return sum(got) / 1e6 if got else None


#: name -> (reader, unit, the end-to-end metric it should move)
READERS = {
    "round_issue_ms": (round_issue_ms, "ms", "round_ms_p50"),
    "read_wait_ms": (read_wait_ms, "ms", "round_ms_p50"),
    "idle_in_round_pct": (idle_in_round_pct, "%", "round_ms_p50"),
    "wasted_supersteps_pct": (wasted_supersteps_pct, "%", "round_ms_p95"),
    "group_table_sync_ms": (group_table_sync_ms, "ms", "placements_per_s"),
    "stage_windows_s": (stage_windows_s, "s", "setup_s"),
}


def self_ms_per_round(events):
    """Each span name's self time (`obs.spans.self_times`) over the
    window's rounds, ms a round."""
    from ksched_tpu_torch.obs.spans import self_times

    rounds = sum(1 for e in events if e["name"] == "round")
    if not rounds:
        return {}
    got = self_times(events)
    return {k: v / rounds / 1e3 for k, v in sorted(got.items(), key=lambda kv: -kv[1])}


def rounds_by_path(events):
    """The window's rounds grouped by their solve's attempts, as
    "<rows>:<site>+<site>..." of their `attempt` spans ("closed form"
    without one): per group the rounds, their mean `round` span and
    mean `read` spans (ms), and how many lie above the window's 95th
    percentile of `round` spans."""
    import numpy as np

    by_sid = _tree(events)
    rounds = {e["args"]["sid"]: [e["dur"], 0.0, []] for e in events if e["name"] == "round"}
    if not rounds:
        return {}
    for e in sorted(events, key=lambda e: e["ts"]):
        r = _round_of(e, by_sid) if e["name"] in ("read", "attempt") else None
        if r is None or r["args"]["sid"] not in rounds:
            continue
        if e["name"] == "read":
            rounds[r["args"]["sid"]][1] += e["dur"]
        else:
            rounds[r["args"]["sid"]][2].append(e["args"])
    p95 = float(np.percentile([d for d, _r, _a in rounds.values()], 95))
    out = {}
    for dur, read, attempts in rounds.values():
        key = (f"{attempts[0]['rows']}:" + "+".join(a["site"] for a in attempts)
               if attempts else "closed form")
        g = out.setdefault(key, {"rounds": 0, "round_ms": 0.0, "read_ms": 0.0, "above_p95": 0})
        g["rounds"] += 1
        g["round_ms"] += dur / 1e3
        g["read_ms"] += read / 1e3
        g["above_p95"] += dur > p95
    for g in out.values():
        g["round_ms"] /= g["rounds"]
        g["read_ms"] /= g["rounds"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["rounds"]))


# ---------------------------------------------------------------------------
# the capture by span
# ---------------------------------------------------------------------------


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _complement(union, w0, w1):
    out, at = [], w0
    for s, t in union:
        if s > at:
            out.append((at, min(s, w1)))
        at = max(at, t)
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return out


def _innermost(ranges):
    """[(start, end, name)] of nested ranges -> disjoint segments, each
    named by the innermost range open over it."""
    bounds = sorted({x for s, t, _n in ranges for x in (s, t)})
    opened = sorted(ranges, key=lambda r: (r[0], -r[1]))
    segs, stack, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(opened) and opened[i][0] <= a:
            stack.append(opened[i])
            i += 1
        stack = [r for r in stack if r[1] > a]
        if stack:
            top = max(stack, key=lambda r: (r[0], -r[1]))
            segs.append((a, b, top[2]))
    return segs


def _overlap(a, b):
    """Seconds of each of b's names over the intervals a: {name: s}."""
    out, j = {}, 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            d = min(t, b[k][1]) - max(s, b[k][0])
            if d > 0:
                out[b[k][2]] = out.get(b[k][2], 0) + d / 1e9
            k += 1
    return out


def capture_by_span(events, names):
    """From a capture's events (kineto events) and the program's span
    names: the card's idle time in the window by the innermost program
    range open over it (`by_span`, `outside` where none is), its total
    (`idle_s`) and the part inside `round` ranges (`in_round_s`), and
    the kernels launched in the window by the innermost program range
    open at their launch (`launches`)."""
    from portbench.trace import BUSY, WINDOW_RANGE, _kind

    w0 = w1 = None
    busy, kernels, ranges, launch_at = [], [], [], {}
    for e in events:
        s, d, kind = e.start_ns(), e.duration_ns(), _kind(e)
        if kind in BUSY:
            busy.append((s, s + d))
            if kind == "kernel":
                link = getattr(e, "linked_correlation_id", None)
                kernels.append((s, link() if link else None))
        elif kind == "host":
            name = e.name()
            if name == WINDOW_RANGE:
                w0, w1 = s, s + d
            elif name in names:
                ranges.append((s, s + d, name))
            launch_at[e.correlation_id()] = s
    if w0 is None:
        return None
    busy = [(max(s, w0), min(t, w1)) for s, t in busy if t > w0 and s < w1]
    idle = _complement(_union(busy), w0, w1)
    segs = _innermost(ranges)
    by_span = _overlap(idle, segs)
    idle_s = sum(t - s for s, t in idle) / 1e9
    by_span[OUTSIDE] = idle_s - sum(by_span.values())
    rounds = [(s, t, "round") for s, t in _union((s, t) for s, t, n in ranges if n == "round")]
    in_round = _overlap(idle, rounds).get("round", 0.0)
    starts = [s for s, _t, _n in segs]
    launches = {}
    for s, link in kernels:
        if not w0 <= s < w1:
            continue
        at = launch_at.get(link)
        name = OUTSIDE
        if at is not None:
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and segs[i][0] <= at < segs[i][1]:
                name = segs[i][2]
        launches[name] = launches.get(name, 0) + 1
    return {"idle_s": idle_s, "in_round_s": in_round,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "launches": dict(sorted(launches.items(), key=lambda kv: -kv[1]))}


class _Events:
    """A capture's profiler with its events filtered, as
    `portbench.trace.Capture.reduce` reads it."""

    def __init__(self, events):
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))


def ranges_check(capture, names) -> dict:
    """The capture reduced as `portbench/trace.py` reduces it, with the
    program's ranges in it and with them taken out: `launches` and
    `busy_s` each as [with, without]."""
    from portbench.trace import Capture

    events = list(capture.prof.profiler.kineto_results.events())
    stripped = [e for e in events if e.name() not in names]
    both = [Capture.reduce(SimpleNamespace(prof=_Events(ev))) for ev in (events, stripped)]
    return {k: [r[k] for r in both] for k in ("launches", "busy_s")}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def _counter_samples():
    """{(name, labels): value} of every counter in the current registry."""
    from ksched_tpu_torch.obs.metrics import get_registry

    out = {}
    for name, fam in get_registry().snapshot().items():
        if fam.get("kind") == "counter":
            for smp in fam["samples"]:
                out[(name, tuple(sorted(smp["labels"].items())))] = smp["value"]
    return out


def run(workload: str, seed: int, seconds: float, profile: bool = True,
        device: str = "cuda", cfg=None, mix=None):
    """One run of `workload` with the tracer installed; returns (the
    harness's line, the ctx the readers read, the capture or None).
    `cfg` and `mix` replace the cell's own (a smaller size)."""
    from ksched_tpu_torch.obs.spans import SpanTracer
    from portbench import harness, trace

    bench = harness.load_benchmark()
    _cell, cell_cfg, cell_mix = harness.find_cell(bench, workload)
    cfg, mix = cfg or cell_cfg, mix or cell_mix
    tracer = SpanTracer(RING)
    got = {"marks": [], "counters": [], "captures": [], "counts": None, "e2e": None}
    plain_counts, plain_e2e = harness.window_counts, harness.end_to_end
    plain_reads, plain_capture = harness.host_reads, trace.Capture

    def host_reads():
        # the harness reads them at the window's two ends
        got["marks"].append(tracer.mark())
        got["counters"].append(_counter_samples())
        return plain_reads()

    def window_counts(system):
        got["counts"] = plain_counts(system)
        return got["counts"]

    def end_to_end(*args):
        got["e2e"] = plain_e2e(*args)
        return got["e2e"]

    class Capture(plain_capture):
        def __init__(self, dev):
            super().__init__(dev)
            got["captures"].append(self)

    saved = [(harness, "host_reads", host_reads), (harness, "window_counts", window_counts),
             (harness, "end_to_end", end_to_end), (trace, "Capture", Capture)]
    saved = [(mod, name, getattr(mod, name), new) for mod, name, new in saved]
    for mod, name, _old, new in saved:
        setattr(mod, name, new)
    tracer.install()
    try:
        line, _faults = harness.run_cell(bench, workload, cfg, mix, seed, seconds, profile,
                                         device, time.perf_counter())
    finally:
        tracer.uninstall()
        for mod, name, old, _new in saved:
            setattr(mod, name, old)
    events = tracer.events()
    m0, m1 = got["marks"]
    first = tracer.total - len(events)  # ring position of events[0]
    whole = tracer.dropped == 0
    c0, c1 = got["counters"]
    ctx = {"spans": events[m0 - first:m1 - first] if whole else None,
           "setup_spans": events[:m0 - first] if whole else None,
           "counters": {k: v - c0.get(k, 0.0) for k, v in c1.items()},
           "counts": got["counts"], "end_to_end": got["e2e"], "dropped": tracer.dropped}
    capture = got["captures"][0] if got["captures"] else None
    if capture is not None:
        names = {e["name"] for e in events}
        ctx["idle_by_span"] = capture_by_span(capture.prof.profiler.kineto_results.events(),
                                              names)
    return line, ctx, capture


def report(workload, seed, line, ctx, capture) -> dict:
    """One run's JSON record (see the module's docstring)."""
    out = {"workload": workload, "seed": seed, "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "end_to_end": ctx["end_to_end"],
           "device": line["device"], "dropped": ctx["dropped"],
           "readers": {name: fn(ctx) for name, (fn, _u, _m) in READERS.items()},
           "self_ms_per_round": self_ms_per_round(ctx["spans"] or []),
           "rounds_by_path": rounds_by_path(ctx["spans"] or []),
           "counters": {name + "".join(f",{k}={v}" for k, v in labels): delta
                        for (name, labels), delta in ctx["counters"].items()
                        if delta and name.startswith(("ksched_device_", "ksched_grouped_"))}}
    idle = ctx.get("idle_by_span")
    if idle is not None:
        out["idle_by_span"] = idle
        names = {e["name"] for e in ctx["spans"] or []} | {
            e["name"] for e in ctx["setup_spans"] or []}
        out["ranges_check"] = ranges_check(capture, names)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    line, ctx, capture = run(args.workload, args.seed, args.seconds, bool(args.profile),
                             args.device)
    rec = json.dumps(report(args.workload, args.seed, line, ctx, capture))
    print(rec, flush=True)
    if args.out:
        with Path(args.out).open("a") as f:
            f.write(rec + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
