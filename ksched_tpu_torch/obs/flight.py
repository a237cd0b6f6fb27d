"""The crash flight recorder: a ring buffer of the last N rounds.

Port of ksched_tpu/obs/flight.py (stdlib only).

Black-box recording for the scheduler service: every round, the
service deposits its RoundRecord plus that round's span events into a
bounded ring; when something goes wrong the whole ring is dumped as
one JSON artifact — the last N rounds of phase timings, fault
attribution, and nested spans leading *up to* the event, which is
exactly what a post-mortem needs and what live metrics (aggregates)
cannot give.

Dump triggers:

- **deadline miss** — the round blew its deadline watchdog
  (`RoundRecord.deadline_miss`);
- **ladder exhaustion** — a NOOP round: every solver rung failed and
  the previous assignments were kept (`RoundRecord.noop_round`);
- **crash** — an uncaught exception, via the chained `sys.excepthook`
  installed by `install_crash_hook()`;
- **manual** — `dump("reason")`, e.g. on SIGTERM from an operator.

Dumps are rate-limited per trigger kind (a flapping solver must not
write a dump per round) and counted on the metrics registry
(`ksched_flight_dumps_total{reason=...}`). The dump file carries the
ring as `rounds` and a flattened `traceEvents` list, so the same file
loads in Perfetto directly.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from dataclasses import asdict
from typing import List, Optional

from .metrics import Registry, get_registry


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 64,
        dump_dir: str = ".",
        registry: Optional[Registry] = None,
        min_rounds_between_dumps: int = 16,
        scope: str = "",
    ) -> None:
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be positive")
        self.ring: deque = deque(maxlen=capacity)
        self.dump_dir = dump_dir
        #: dump-filename discriminator (and solver-stall filter) for
        #: recorders sharing one dump dir — the multi-tenant service
        #: runs one recorder PER TENANT, and round-keyed-only filenames
        #: would let two tenants dumping in the same round clobber each
        #: other
        self.scope = scope
        self.min_rounds_between_dumps = min_rounds_between_dumps
        self.dumps: List[str] = []  # paths written, oldest first
        self.rounds_seen = 0
        self._last_dump_round = {}  # reason -> rounds_seen at last dump
        reg = registry if registry is not None else get_registry()
        self._dump_metric = reg.counter(
            "ksched_flight_dumps_total",
            "flight-recorder dumps by trigger",
            labelnames=("reason",),
        )
        self._prev_excepthook = None

    # -- recording ---------------------------------------------------------

    def note_round(self, record, span_events: Optional[List[dict]] = None) -> Optional[str]:
        """Deposit one round (RoundRecord + its span events); auto-dumps
        and returns the dump path when the record trips a trigger."""
        self.rounds_seen += 1
        self.ring.append(
            {
                "record": asdict(record),
                "spans": list(span_events) if span_events else [],
            }
        )
        if getattr(record, "deadline_miss", False):
            return self._maybe_dump("deadline_miss")
        if getattr(record, "noop_round", False):
            return self._maybe_dump("noop_round")
        return None

    def trigger(self, reason: str) -> Optional[str]:
        """External dump trigger (e.g. a state-divergence event), with
        the same per-reason rate limit as the built-in triggers."""
        return self._maybe_dump(reason)

    def _maybe_dump(self, reason: str) -> Optional[str]:
        last = self._last_dump_round.get(reason)
        if last is not None and self.rounds_seen - last < self.min_rounds_between_dumps:
            return None
        self._last_dump_round[reason] = self.rounds_seen
        return self.dump(reason)

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Write the ring out; returns the path. The payload is both a
        flight dump (`rounds`) and a Chrome trace (`traceEvents`)."""
        if path is None:
            tag = f"{self.scope}_" if self.scope else ""
            path = os.path.join(
                self.dump_dir, f"flight_{tag}{reason}_r{self.rounds_seen:06d}.json"
            )
            # two recorders in one dir (or a restarted service whose
            # round counter reset) must never clobber an existing dump:
            # the filename is a post-mortem artifact, not a slot
            if os.path.exists(path):
                i = 1
                stem, ext = os.path.splitext(path)
                while os.path.exists(f"{stem}_{i}{ext}"):
                    i += 1
                path = f"{stem}_{i}{ext}"
        # the dir may not exist yet (--flight-dir ./flight on a fresh
        # checkout) or may have been removed mid-run; a failed dump must
        # not kill the service loop it exists to post-mortem
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        rounds = list(self.ring)
        trace_events = [ev for entry in rounds for ev in entry["spans"]]
        # solver-interior stall events (structured reasons + the final
        # K supersteps of telemetry) ride along in every dump: a NOOP
        # round's post-mortem needs to show WHY the ladder exhausted,
        # not just that it did
        from .soltel import recent_stalls

        stalls = recent_stalls()
        if self.scope:
            # a tenant-scoped recorder's post-mortem must not carry
            # OTHER tenants' stall attribution; untagged events (from
            # code outside any tenant scope) stay visible to all
            stalls = [
                s for s in stalls
                if s.get("tenant") in (None, self.scope)
            ]
        payload = {
            "reason": reason,
            "captured_at": time.time(),
            "rounds_seen": self.rounds_seen,
            "rounds": rounds,
            "traceEvents": trace_events,
            "solver_stalls": stalls,
            "scope": self.scope,
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        self.dumps.append(path)
        self._dump_metric.labels(reason=reason).inc()
        return path

    # -- crash hook --------------------------------------------------------

    def install_crash_hook(self) -> None:
        """Chain onto sys.excepthook: dump the ring on an uncaught
        exception, then defer to the previous hook (traceback printing
        survives). Idempotent."""
        if self._prev_excepthook is not None:
            return
        prev = sys.excepthook
        self._prev_excepthook = prev

        def hook(exc_type, exc, tb):
            try:
                self.dump("crash")
            except Exception:  # noqa: BLE001 — never mask the original crash
                pass
            prev(exc_type, exc, tb)

        sys.excepthook = hook

    def uninstall_crash_hook(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
