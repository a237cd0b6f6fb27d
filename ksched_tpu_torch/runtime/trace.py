"""First-class round tracing.

The reference times rounds ad hoc in its CLI (`time.Since` around
ScheduleAllJobs, cmd/k8sscheduler/scheduler.go:146-150) and discards the
solver's own timing lines (placement/solver.go:169-170). Here every
round yields a structured record — per-phase wall clock (the RoundTiming
breakdown, itself derived from obs span durations), mutation counts
(ChangeStats), solver effort — exportable as JSON lines and
summarizable as percentiles.

The tracer is also the metrics publication point: every record it
appends is simultaneously published to the obs metrics registry
(rounds/faults/retries/degradations counters, per-phase latency
histograms), so the live `/metricsz` surface and the JSONL artifact
are two views of the same records and reconcile exactly at any
instant — the obs smoke asserts this over a chaos soak.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..obs.metrics import get_registry, log_buckets


@dataclass
class RoundRecord:
    round_index: int
    wall_time: float  # epoch seconds at record time
    phases_ms: Dict[str, float]
    num_scheduled: int = 0
    solver_work: int = 0  # supersteps / iterations / augmentations
    nodes_added: int = 0
    arcs_added: int = 0
    arcs_changed: int = 0
    arcs_removed: int = 0
    # -- robustness observability (chaos harness / hardened loop): every
    # injected fault, retry, degradation, and heartbeat expiry is
    # attributable to the round it landed in --------------------------------
    faults_injected: Dict[str, int] = field(default_factory=dict)
    retries: int = 0  # control-plane retry/re-post attempts this round
    degradations: int = 0  # solver rungs stepped down this round
    solver_rung: int = 0  # ladder rung that produced the round; -1 = no solve (NOOP if noop_round, else an idle sweep)
    noop_round: bool = False  # ladder exhausted: previous assignments kept
    deadline_miss: bool = False  # round blew its watchdog deadline
    machines_lost: int = 0  # heartbeat-expired machines this sweep
    tasks_failed: int = 0  # heartbeat-expired tasks this sweep
    #: owning cell in a multi-tenant service ("" = single-tenant): the
    #: per-tenant soak and ksched_tpu_torch/tools/obs_report.py's
    #: per-tenant view group round records on this, and the
    #: zero-cross-tenant-interference check relies on fault/degradation
    #: counters landing ONLY in the chaos tenant's records
    tenant: str = ""


class RoundTracer:
    def __init__(self, capacity: Optional[int] = None, registry=None) -> None:
        self.records: List[RoundRecord] = []
        self.capacity = capacity
        # metric handles resolve at construction time (scoped_registry
        # gives a soak run private per-run accounting); with obs
        # disabled these are inert null metrics
        reg = registry if registry is not None else get_registry()
        self._m_rounds = reg.counter(
            "ksched_rounds_total",
            "scheduling rounds by kind (sched = solved, idle = sweep-only, "
            "noop = ladder exhausted, previous assignments kept)",
            labelnames=("kind",),
        )
        self._m_phase = reg.histogram(
            "ksched_round_phase_ms",
            "per-phase round latency (solved rounds only; idle sweeps and "
            "NOOP rounds carry no phase timings)",
            labelnames=("phase",),
        )
        self._m_scheduled = reg.counter(
            "ksched_scheduled_tasks_total", "tasks placed across all rounds"
        )
        self._m_faults = reg.counter(
            "ksched_faults_attributed_total",
            "injected faults attributed to a round's record, by kind "
            "(reconciles against ksched_chaos_injected_total)",
            labelnames=("kind",),
        )
        self._m_retries = reg.counter(
            "ksched_retries_total", "control-plane retry/re-post attempts"
        )
        self._m_degr = reg.counter(
            "ksched_round_degradations_total",
            "solver rungs stepped down, attributed per round",
        )
        self._m_miss = reg.counter(
            "ksched_deadline_misses_total", "rounds that blew the watchdog deadline"
        )
        self._m_lost = reg.counter(
            "ksched_machines_lost_total", "heartbeat-expired machines"
        )
        self._m_failed = reg.counter(
            "ksched_tasks_failed_total", "heartbeat-expired tasks"
        )
        self._m_graph = reg.counter(
            "ksched_graph_changes_total",
            "graph-delta journal records by kind",
            labelnames=("kind",),
        )
        self._m_work = reg.histogram(
            "ksched_round_solver_work",
            "solver supersteps/iterations per solved round",
            buckets=log_buckets(1, 1 << 20, 2.0),
        )

    def _publish(self, rec: RoundRecord) -> None:
        """Mirror one record onto the metrics registry. Called for every
        appended record, so summed records == served counters, always."""
        kind = (
            "noop" if rec.noop_round
            else ("idle" if rec.solver_rung == -1 else "sched")
        )
        self._m_rounds.labels(kind=kind).inc()
        if kind == "sched":
            for phase, ms in rec.phases_ms.items():
                self._m_phase.labels(phase=phase).observe(ms)
            if rec.solver_work:
                self._m_work.observe(rec.solver_work)
        if rec.num_scheduled:
            self._m_scheduled.inc(rec.num_scheduled)
        for k, v in rec.faults_injected.items():
            if v:
                self._m_faults.labels(kind=k).inc(v)
        if rec.retries:
            self._m_retries.inc(rec.retries)
        if rec.degradations:
            self._m_degr.inc(rec.degradations)
        if rec.deadline_miss:
            self._m_miss.inc()
        if rec.machines_lost:
            self._m_lost.inc(rec.machines_lost)
        if rec.tasks_failed:
            self._m_failed.inc(rec.tasks_failed)
        for kind_, n in (
            ("nodes_added", rec.nodes_added),
            ("arcs_added", rec.arcs_added),
            ("arcs_changed", rec.arcs_changed),
            ("arcs_removed", rec.arcs_removed),
        ):
            if n:
                self._m_graph.labels(kind=kind_).inc(n)

    # -- recording --------------------------------------------------------

    def record_flow_round(
        self,
        scheduler,
        num_scheduled: int,
        extra: Optional[Dict] = None,
        solved: bool = True,
    ) -> RoundRecord:
        """Capture a FlowScheduler round from its last_timing + stats.
        ``extra`` carries the robustness counters (faults_injected,
        retries, degradations, …) the hardened service loop attributes
        to this round; unknown keys are rejected so counter names
        cannot silently drift from the RoundRecord schema.

        ``solved=False`` marks an idle sweep (no graph rebuild/solve
        ran): the scheduler's dimacs_stats and solver-work counters
        still hold the *previous* solved round's values and must not be
        re-reported, or trace aggregations would multi-count that round
        once per quiet poll."""
        t = scheduler.last_timing
        stats = scheduler.dimacs_stats if solved else None
        backend = getattr(scheduler.solver, "backend", None) if solved else None
        rec = RoundRecord(
            round_index=len(self.records),
            wall_time=time.time(),
            phases_ms={
                "stats": t.stats_s * 1e3,
                "graph_update": t.graph_update_s * 1e3,
                "solve": t.solve_s * 1e3,
                "deltas": t.deltas_s * 1e3,
                "apply": t.apply_s * 1e3,
                "total": t.total_s * 1e3,
            },
            num_scheduled=num_scheduled,
            solver_work=getattr(backend, "last_iterations", 0)
            or getattr(backend, "last_supersteps", 0),
            nodes_added=stats.nodes_added if stats else 0,
            arcs_added=stats.arcs_added if stats else 0,
            arcs_changed=stats.arcs_changed if stats else 0,
            arcs_removed=stats.arcs_removed if stats else 0,
        )
        for k, v in (extra or {}).items():
            if not hasattr(rec, k):
                raise ValueError(f"unknown RoundRecord field {k!r}")
            setattr(rec, k, v)
        self._append(rec)
        return rec

    def record_bulk_round(self, cluster, result) -> RoundRecord:
        """Capture a BulkCluster round from its BulkRoundResult."""
        backend = cluster.backend
        return self.record_timed_round(
            result.timing,
            num_scheduled=len(result.placed_tasks),
            solver_work=getattr(backend, "last_supersteps", 0)
            or getattr(backend, "last_iterations", 0),
        )

    def record_timed_round(
        self,
        timing: Dict[str, float],
        total_ms: Optional[float] = None,
        num_scheduled: int = 0,
        solver_work: int = 0,
    ) -> RoundRecord:
        """Capture an externally timed round from a `{phase}_s` dict
        (bench.py's post-measurement publication path). `total_ms`
        overrides the summed-phases total with a measured wall time.
        This is the one place the timing-key → phase-name mapping
        lives, so bench snapshots carry exactly the series the service
        publishes."""
        phases_ms = {k[:-2]: v * 1e3 for k, v in timing.items()}
        phases_ms["total"] = (
            total_ms if total_ms is not None else sum(phases_ms.values())
        )
        rec = RoundRecord(
            round_index=len(self.records),
            wall_time=time.time(),
            phases_ms=phases_ms,
            num_scheduled=num_scheduled,
            solver_work=solver_work,
        )
        self._append(rec)
        return rec

    def _append(self, rec: RoundRecord) -> None:
        self._publish(rec)
        self.records.append(rec)
        if self.capacity is not None and len(self.records) > self.capacity:
            del self.records[0]

    # -- export -----------------------------------------------------------

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(asdict(r)) for r in self.records)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl() + ("\n" if self.records else ""))

    def summary(self, phase: str = "total") -> Dict[str, float]:
        """Phase percentiles over SOLVED rounds. Idle sweeps (sweep-only
        quiet polls: ``solver_rung == -1`` without ``noop_round``) carry
        zeroed phase timings by construction and would drag an
        idle-heavy soak's p50 toward zero, so they are excluded from
        the percentiles and reported as ``idle_rounds`` instead. NOOP
        rounds are different — a *failed* solve is part of the latency
        story, not a skipped one — so they stay in the population."""
        idle = sum(
            1 for r in self.records if r.solver_rung == -1 and not r.noop_round
        )
        vals = np.array(
            [
                r.phases_ms.get(phase, 0.0)
                for r in self.records
                if not (r.solver_rung == -1 and not r.noop_round)
            ],
            dtype=np.float64,
        )
        if not len(vals):
            return {"rounds": 0, "idle_rounds": idle}
        return {
            "rounds": len(vals),
            "idle_rounds": idle,
            "p50_ms": float(np.percentile(vals, 50)),
            "p90_ms": float(np.percentile(vals, 90)),
            "p99_ms": float(np.percentile(vals, 99)),
            "mean_ms": float(vals.mean()),
            "max_ms": float(vals.max()),
        }
