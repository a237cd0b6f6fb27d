"""Hierarchical span tracing with Chrome/Perfetto trace-event export.

The flat `phases_ms` dict the round trace carried (runtime/trace.py)
could say *that* a round spent 7 ms in "solve" but not *where*: graph
export vs backend dispatch vs rung fallback vs decode. Spans make the
nesting first-class — round → schedule → {stats, graph_update, solve →
{graph_export, backend_solve → solver_rung…}, deltas, apply} — and the
whole tree exports as Chrome trace-event JSON that loads directly in
Perfetto / chrome://tracing.

Two-layer design, so instrumentation costs ~nothing when unused:

- `span(name, **args)` is a context manager that ALWAYS times (two
  `perf_counter` calls — exactly what the hand-rolled timing it
  replaces cost). `RoundTiming` in scheduler/flow_scheduler.py is
  populated from these spans' durations, which is what makes the round
  trace a *consumer* of the same measurements the live trace exports:
  the JSONL artifact and a captured Perfetto trace can never disagree.
- recording only happens while a `SpanTracer` is installed
  (`tracer.install()` / `with tracer:`); with none installed the span
  skips the contextvar parenting entirely, and calls nothing of torch.

One clock with the device trace: while a tracer is installed and a
`torch.profiler` is recording, each span also opens a profiler range
under its own name, so the program's phases sit in the profiler's
capture on the capture's own (epoch) clock, beside the kernels and
copies they issue. The tracer's own events keep the `perf_counter`
base; `install()` takes the offset between the two clocks once, and the
Chrome export records it, so a span file and a device trace merge.

Parenting is contextvar-based, so spans nest correctly across threads
and (if the host app uses them) asyncio tasks; each recorded event
carries its span id and parent span id in `args` in addition to the
time containment Perfetto uses for visual nesting. A span that exits
via an exception records `args.error` and still closes cleanly, so an
aborted round leaves a well-formed trace behind (the flight recorder
depends on that).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "ksched_obs_span", default=None
)
_active: Optional["SpanTracer"] = None
_ids = itertools.count(1)


class Span:
    """One timed region. Use as a context manager, or manually via
    `start_span()` / `.finish()` when the region spans methods (the
    pipelined round's dispatch→finish gap)."""

    __slots__ = (
        "name", "args", "sid", "parent_sid", "parent_name",
        "t0_s", "t1_s", "dur_s", "_token", "_tracer", "_range",
    )

    def __init__(self, name: str, args: Optional[Dict] = None) -> None:
        self.name = name
        self.args = args
        self.sid = 0
        self.parent_sid = 0
        self.parent_name: Optional[str] = None
        self.t0_s = 0.0
        self.t1_s = 0.0
        self.dur_s = 0.0
        self._token = None
        self._tracer: Optional[SpanTracer] = None
        self._range = None

    def set(self, key: str, value) -> None:
        """Attach an arg after entry (e.g. a superstep count only known
        once the solve returns)."""
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def __enter__(self) -> "Span":
        tracer = _active
        self._tracer = tracer
        if tracer is not None:
            parent = _current.get()
            self.sid = next(_ids)
            if parent is not None:
                self.parent_sid = parent.sid
                self.parent_name = parent.name
            self._token = _current.set(self)
            self._range = tracer._open_range(self.name)
        self.t0_s = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.t1_s:
            return False  # already closed (error-path re-close is a no-op)
        t1 = time.perf_counter()
        self.t1_s = t1
        self.dur_s = t1 - self.t0_s
        tracer = self._tracer
        if tracer is not None:
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None
            _current.reset(self._token)
            self._token = None
            if exc_type is not None:
                self.set("error", f"{exc_type.__name__}: {exc}")
            tracer._record(self)
        return False

    def finish(self) -> float:
        """Close a manually-started span; returns its duration."""
        self.__exit__(None, None, None)
        return self.dur_s


def span(name: str, **args) -> Span:
    """Open a (not-yet-entered) span; `with span("solve") as sp:`."""
    return Span(name, args or None)


def start_span(name: str, **args) -> Span:
    """Enter a span immediately (manual-finish form)."""
    return Span(name, args or None).__enter__()


def active_tracer() -> Optional["SpanTracer"]:
    return _active


def unwind(outer: Span, exc_type, exc, tb) -> None:
    """Error-path close for manual-span regions: close every open span
    from the current innermost up to and including `outer`, so the
    error is recorded on each and the contextvar parenting is restored
    for whatever runs next on this thread. A span entered with no
    tracer installed never touched the contextvar — then only `outer`
    itself needs closing (for its duration; nothing records)."""
    if outer._tracer is None or outer.t1_s:
        outer.__exit__(exc_type, exc, tb)
        return
    while True:
        cur = _current.get()
        if cur is None or cur.t1_s:
            # chain unexpectedly broken; still close outer
            outer.__exit__(exc_type, exc, tb)
            return
        done = cur is outer
        cur.__exit__(exc_type, exc, tb)
        if done:
            return


def self_times(events: List[dict]) -> Dict[str, float]:
    """Each span name's self time in µs over a SpanTracer's events: its
    spans' durations less those of their children among `events`."""
    by_sid = {e["args"]["sid"]: e for e in events if "sid" in e.get("args", {})}
    out: Dict[str, float] = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
        parent = by_sid.get(e.get("args", {}).get("parent_sid"))
        if parent is not None:
            out[parent["name"]] = out.get(parent["name"], 0.0) - e["dur"]
    return out


def _profiler_hooks():
    """(is a torch.profiler recording, a profiler range's context
    manager); torch is imported here, not with the module."""
    import torch

    return torch._C._autograd._profiler_enabled, torch._C._profiler._RecordFunctionFast


class SpanTracer:
    """Collects finished spans as Chrome trace events in a bounded ring.

    `mark()`/`events_since(mark)` slice out one round's spans for the
    flight recorder; `chrome_trace()`/`dump()` export the whole ring
    for Perfetto. Thread-safe: spans finish on whichever thread ran
    them (the service thread, watch threads, the watchdog timer)."""

    def __init__(self, capacity: int = 1 << 16) -> None:
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.total = 0  # spans ever recorded (ring may have dropped some)
        self.dropped = 0
        self._prev: Optional[SpanTracer] = None
        #: epoch ns = perf_counter ns + this, taken at install()
        self.epoch_offset_ns = 0
        #: (is a profiler recording, a profiler range), set at install()
        self._profiler = None

    def _open_range(self, name: str):
        """An entered profiler range named `name` while a
        torch.profiler records, else None."""
        hooks = self._profiler
        if not hooks[0]():
            return None
        rng = hooks[1](name)
        rng.__enter__()
        return rng

    # -- recording ---------------------------------------------------------

    def _append(self, name: str, t0_s: float, dur_s: float, args: Dict) -> None:
        """One Chrome-event construction + locked ring append for both
        recorded spans and synthesized events — the schema must never
        fork between the two."""
        event = {
            "ph": "X",
            "cat": "ksched",
            "name": name,
            "ts": t0_s * 1e6,  # perf_counter base: monotonic, shared in-process
            "dur": dur_s * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)
            self.total += 1

    def _record(self, sp: Span) -> None:
        args = dict(sp.args) if sp.args else {}
        args["sid"] = sp.sid
        if sp.parent_sid:
            args["parent_sid"] = sp.parent_sid
            args["parent"] = sp.parent_name
        self._append(sp.name, sp.t0_s, sp.t1_s - sp.t0_s, args)

    def record_event(self, name: str, t0_s: float, dur_s: float, args: Optional[Dict] = None) -> None:
        """Record a SYNTHESIZED complete event (no live Span object):
        the solver-interior telemetry decode (obs/soltel.py) fabricates
        per-superstep child spans under a backend_solve span from
        device counters, apportioning the parent's wall time — the
        device cannot produce host timestamps itself. Events land in
        the same ring with the same schema as recorded spans."""
        self._append(name, t0_s, dur_s, dict(args) if args else {})

    # -- slicing (flight recorder) -----------------------------------------

    def mark(self) -> int:
        with self._lock:
            return self.total

    def events_since(self, mark: int) -> List[dict]:
        """Events recorded after `mark` (oldest may be lost to the ring;
        what remains is returned). islice, not a full-ring copy: the
        flight recorder calls this every round to slice out the last
        ~dozen events of a ring that may hold 64k."""
        with self._lock:
            want = self.total - mark
            skip = max(0, len(self._events) - want)
            return list(itertools.islice(self._events, skip, None))

    # -- export ------------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """The ring as Chrome trace JSON: event times in µs on the
        perf_counter base; `otherData.epoch_offset_ns` takes them to the
        profiler's epoch clock (ts * 1e3 + offset = epoch ns)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"epoch_offset_ns": self.epoch_offset_ns}}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    # -- activation --------------------------------------------------------

    def install(self) -> "SpanTracer":
        """Make this the process-active tracer (stacking: uninstall
        restores the previous one)."""
        global _active
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        self.epoch_offset_ns = wall - (p0 + p1) // 2
        self._profiler = _profiler_hooks()
        self._prev = _active
        _active = self
        return self

    def uninstall(self) -> None:
        global _active
        if _active is self:
            _active = self._prev
        self._prev = None

    def __enter__(self) -> "SpanTracer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
