"""Device-side accounting: solver effort, host→device traffic, and
opt-in `torch.profiler` capture.

Port of ksched_tpu/obs/devprof.py. The solvers run their superstep
loops on the device (kernel B3's one launch, or the plain solves'
per-superstep launches), so what the host can observe, this module
records:

- per-solve effort (supersteps / iterations) as a log-bucketed
  histogram and a per-backend solve counter;
- host→device bytes per round, from the placement driver's export
  path: the device-resident mirror's exact count of the bytes it copied
  (packed delta records, or the rebuild upload), else a full build's
  whole FlowProblem (exact `nbytes`), else the change journal (estimated
  at the flat-array record sizes);
- an opt-in `torch.profiler` capture (CPU and, where there is a card,
  CUDA activity) bracketing the Nth solve: one trace of a steady-state
  solve without paying profiler overhead on every round. The trace is
  written as Chrome trace JSON into `capture_dir` and the profiler
  object is kept as `last_capture` for `key_averages()`;
- the device round's bounded attempts (`DeviceSolveCounters`): each
  attempt kept or discarded by its site, the supersteps the discarded
  ones spent, and each grouped solve's rows and path.

One module-level profiler is the default sink (`get_profiler()`), so
the placement driver needs no plumbing; tests install private instances
via `set_profiler` for per-run registries.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional

from .metrics import Registry, get_registry, log_buckets

#: estimated flat-array bytes scattered per journaled arc change: slots
#: in src/dst/cap/cost/flow_offset (4 B each, graph/device_export.py)
ARC_RECORD_BYTES = 20
#: estimated bytes per journaled node change: excess (8 B) + node_type
NODE_RECORD_BYTES = 9


def problem_nbytes(problem) -> int:
    """Exact bytes of a FlowProblem's arrays (the full-build upload)."""
    total = 0
    for name in ("excess", "node_type", "src", "dst", "cap", "cost", "flow_offset"):
        arr = getattr(problem, name, None)
        total += int(getattr(arr, "nbytes", 0))
    return total


def delta_nbytes(stats) -> int:
    """Estimated bytes scattered by one incremental round's journal
    (ChangeStats counts × flat-array record sizes)."""
    arcs = stats.arcs_added + stats.arcs_changed + stats.arcs_removed
    nodes = stats.nodes_added + stats.nodes_removed
    return arcs * ARC_RECORD_BYTES + nodes * NODE_RECORD_BYTES


def journal_nbytes(changes) -> int:
    """Estimated bytes scattered by one applied change journal, counted
    from the journal itself (arc records carry src/dst; the rest are
    node records). Preferred over `delta_nbytes`: the journal is
    exactly what apply_changes scatters, while per-round ChangeStats
    miss the previous round's post-solve mutations."""
    arcs = sum(1 for c in changes if hasattr(c, "src"))
    return arcs * ARC_RECORD_BYTES + (len(changes) - arcs) * NODE_RECORD_BYTES


class DeviceProfiler:
    """The per-solve accounting sink + the Nth-solve torch.profiler hook."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        capture_solve: int = 0,
        capture_dir: str = "./devprof",
    ) -> None:
        reg = registry if registry is not None else get_registry()
        self.solves = reg.counter(
            "ksched_solves_total",
            "backend solves by the rung/backend that produced the result",
            labelnames=("backend",),
        )
        self.solver_work = reg.histogram(
            "ksched_solver_work",
            "supersteps/iterations per solve",
            labelnames=("backend",),
            buckets=log_buckets(1, 1 << 20, 2.0),
        )
        self.h2d_bytes = reg.counter(
            "ksched_h2d_bytes_total",
            "host->device bytes shipped by graph export (full builds exact, "
            "incremental deltas estimated from ChangeStats)",
            labelnames=("kind",),
        )
        self.problem_arcs = reg.gauge(
            "ksched_problem_arcs", "live arc slots in the last exported problem"
        )
        self.problem_nodes = reg.gauge(
            "ksched_problem_nodes", "dense node extent of the last exported problem"
        )
        self.captures = reg.counter(
            "ksched_devprof_captures_total", "torch.profiler traces captured"
        )
        self.capture_solve = capture_solve
        self.capture_dir = capture_dir
        #: the finished torch.profiler.profile of the captured solve, the
        #: Chrome trace it was written to, and the host seconds that
        #: starting, stopping and exporting the capture took (the
        #: instrument's own cost, inside the captured round)
        self.last_capture = None
        self.last_capture_path: Optional[str] = None
        self.last_capture_cost_s = 0.0
        self._solve_index = 0
        self._profile = None
        self._capture_failed = False

    # -- export accounting -------------------------------------------------

    def note_export(
        self, problem, full: bool, stats=None, changes=None,
        exact_bytes: Optional[int] = None,
    ) -> None:
        """``exact_bytes`` is the measured host→device byte count from
        the device-resident export path (packed delta-record nbytes, or
        the rebuild upload) — exact accounting, preferred over every
        estimate below. The non-resident paths re-upload full arrays
        but their *delta-relevant* traffic is estimated from the
        journal (``journal_nbytes``) or, lacking one, ChangeStats."""
        if exact_bytes is not None:
            kind = "full_build" if full else "delta"
            self.h2d_bytes.labels(kind=kind).inc(exact_bytes)
        elif full:
            self.h2d_bytes.labels(kind="full_build").inc(problem_nbytes(problem))
        elif changes is not None:
            self.h2d_bytes.labels(kind="delta").inc(journal_nbytes(changes))
        elif stats is not None:
            self.h2d_bytes.labels(kind="delta").inc(delta_nbytes(stats))
        self.problem_arcs.set(problem.num_arcs)
        self.problem_nodes.set(problem.num_nodes)

    # -- solve accounting + Nth-solve capture ------------------------------

    def solve_starting(self) -> None:
        """Called just before a backend solve is dispatched; starts the
        torch.profiler capture when this is the configured Nth solve."""
        self._solve_index += 1
        if (
            self.capture_solve > 0
            and self._solve_index == self.capture_solve
            and not self._capture_failed
        ):
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                t0 = time.perf_counter()
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                prof = profile(activities=activities)
                prof.start()
                self._profile = prof
                self.last_capture_cost_s = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — profiling is best-effort
                self._capture_failed = True
                warnings.warn(
                    f"devprof: torch.profiler capture unavailable ({e}); disabled",
                    RuntimeWarning,
                    stacklevel=2,
                )

    def _stop_capture(self) -> None:
        prof, self._profile = self._profile, None
        if prof is None:
            return
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof.stop()
            os.makedirs(self.capture_dir, exist_ok=True)
            path = os.path.join(self.capture_dir, f"solve_{self._solve_index}.json")
            prof.export_chrome_trace(path)
            self.last_capture_cost_s += time.perf_counter() - t0
            self.last_capture, self.last_capture_path = prof, path
            self.captures.inc()
        except Exception as e:  # noqa: BLE001
            warnings.warn(
                f"devprof: torch.profiler stop failed ({e})",
                RuntimeWarning,
                stacklevel=2,
            )

    def solve_failed(self) -> None:
        """Called when a dispatched solve raises (a stall, ladder
        exhaustion): stop a capture started for this solve so the 'one
        solve' trace neither bleeds into later rounds nor runs forever
        when no solve ever completes."""
        self._stop_capture()

    def note_solve(self, backend, problem, result) -> None:
        """Called once per completed solve by the placement driver."""
        self._stop_capture()
        name = getattr(backend, "last_rung_name", None) or type(backend).__name__
        work = int(getattr(result, "iterations", 0) or 0)
        if not work:
            work = int(
                getattr(backend, "last_iterations", 0)
                or getattr(backend, "last_supersteps", 0)
                or 0
            )
        self.solves.labels(backend=name).inc()
        if work:
            self.solver_work.labels(backend=name).observe(work)


#: the device round's attempt sites: the grouped stage 1, the grouped
#: full solve (or any attempt from the full range), a short-start first
#: attempt, and its full-range retry
ATTEMPT_SITES = ("stage1", "full", "eps0", "retry")
#: a grouped solve's paths (DeviceBulkCluster.last_grouped_path)
GROUPED_PATHS = ("two-stage", "fallback", "full")


class DeviceSolveCounters:
    """The device round's solve accounting, on the registry that is
    current at construction, each labelled child bound there so that a
    round pays only `inc`.

    An attempt is counted when its outcome is known: `attempt` opens
    one (and keeps the one before it, which nothing discarded);
    `discard` drops the open one, and counts its budget as the
    supersteps it spent — an attempt is discarded only when it did not
    converge, and a bounded solve stops short of its budget only by
    converging; `settle` keeps it."""

    def __init__(self, registry: Optional[Registry] = None, grouped_rows=()) -> None:
        reg = registry if registry is not None else get_registry()
        attempts = reg.counter(
            "ksched_device_solve_attempts_total",
            "device-round bounded solve attempts by site and outcome",
            labelnames=("site", "outcome"),
        )
        wasted = reg.counter(
            "ksched_device_discarded_supersteps_total",
            "supersteps of device-round attempts whose result was discarded",
            labelnames=("site",),
        )
        self._kept = {s: attempts.labels(site=s, outcome="kept") for s in ATTEMPT_SITES}
        self._discarded = {s: (attempts.labels(site=s, outcome="discarded"),
                               wasted.labels(site=s)) for s in ATTEMPT_SITES}
        self._grouped = {}
        if grouped_rows:
            solves = reg.counter(
                "ksched_grouped_solves_total",
                "grouped device-round solves by rows (the ladder rung) and path",
                labelnames=("rows", "path"),
            )
            self._grouped = {(r, p): solves.labels(rows=str(r), path=p)
                             for r in grouped_rows for p in GROUPED_PATHS}
        self._open = None  # (site, budget) of the attempt last opened

    def attempt(self, site: str, budget: int) -> None:
        self.settle()
        self._open = (site, budget)

    def settle(self) -> None:
        if self._open is not None:
            self._kept[self._open[0]].inc()
            self._open = None

    def discard(self) -> None:
        if self._open is not None:
            site, budget = self._open
            self._open = None
            count, steps = self._discarded[site]
            count.inc()
            steps.inc(budget)

    def grouped(self, rows: int, path: str) -> None:
        self._grouped[(rows, path)].inc()


_profiler: Optional[DeviceProfiler] = None


def get_profiler() -> DeviceProfiler:
    """The module-default profiler (created lazily on the registry that
    is current at first use)."""
    global _profiler
    if _profiler is None:
        _profiler = DeviceProfiler()
    return _profiler


def set_profiler(profiler: Optional[DeviceProfiler]) -> None:
    """Install a configured profiler (per-run registry / Nth-solve
    capture); None resets to lazy-default."""
    global _profiler
    _profiler = profiler
