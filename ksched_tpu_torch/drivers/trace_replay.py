"""Google 2011 cluster-trace replay: the trace streams, the windowing
protocol and the two replay drivers.

The reference carries trace-replay identity fields precisely so the
Google trace can be replayed through the scheduler
(TaskDescriptor.trace_job_id/trace_task_id, proto/task_desc.proto:76-78;
ResourceDescriptor.trace_machine_id, resource_desc.proto:62-63) but
ships no replay driver. This is that driver, over the bulk array paths
so the 12.5k-machine trace scale (BASELINE config 5) solves as dense
transports.

Input format: the public clusterdata-2011 schema —
  machine_events: timestamp_us, machine_id, event_type(0 ADD/1 REMOVE/
                  2 UPDATE), platform_id, cpus, memory
  task_events:    timestamp_us, missing_info, job_id, task_index,
                  machine_id, event_type(0 SUBMIT/1 SCHEDULE/2 EVICT/
                  3 FAIL/4 FINISH/5 KILL/6 LOST/7-8 UPDATE), user,
                  scheduling_class, priority, cpu_req, ram_req,
                  disk_req, different_machine_constraint
CSV (optionally .gz), as published. The published CSVs are a download,
so `synthesize_trace` fabricates streams with the same schema and
realistic arrival/finish dynamics for benchmarks and tests; for a seed
it gives the same streams as ksched_tpu's, event for event.

Replay protocol: events are consumed in timestamp order and batched
into fixed simulated-time windows (the trace analogue of the
reference's 2s pod-batch debounce, k8sclient/client.go:153-193); each
window ends with one scheduling round; FINISH/KILL/EVICT free slots.
`TraceReplayDriver` replays them through the host BulkCluster one
window at a time; `DeviceTraceReplayDriver` stages every window into
fixed-width arrays up front and replays them on DeviceBulkCluster.
Everything here but the two clusters is numpy and Python.
"""

from __future__ import annotations

import csv
import gzip
import io
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

# task_events event_type values (clusterdata-2011 schema)
SUBMIT, SCHEDULE, EVICT, FAIL, FINISH, KILL, LOST = 0, 1, 2, 3, 4, 5, 6
MACHINE_ADD, MACHINE_REMOVE, MACHINE_UPDATE = 0, 1, 2


@dataclass(frozen=True)
class TraceTaskEvent:
    time_us: int
    job_id: int
    task_index: int
    event_type: int
    scheduling_class: int = 0
    priority: int = 0
    cpu_req: float = 0.0


@dataclass(frozen=True)
class TraceMachineEvent:
    time_us: int
    machine_id: int
    event_type: int
    cpus: float = 1.0


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def parse_task_events(path: str) -> Iterator[TraceTaskEvent]:
    """Stream task events from a clusterdata-2011 task_events CSV."""
    with _open_maybe_gz(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            yield TraceTaskEvent(
                time_us=int(row[0]),
                job_id=int(row[2]),
                task_index=int(row[3]),
                event_type=int(row[5]),
                scheduling_class=int(row[7]) if len(row) > 7 and row[7] else 0,
                priority=int(row[8]) if len(row) > 8 and row[8] else 0,
                cpu_req=float(row[9]) if len(row) > 9 and row[9] else 0.0,
            )


def parse_machine_events(path: str) -> Iterator[TraceMachineEvent]:
    """Stream machine events from a clusterdata-2011 machine_events CSV."""
    with _open_maybe_gz(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            yield TraceMachineEvent(
                time_us=int(row[0]),
                machine_id=int(row[1]),
                event_type=int(row[2]),
                cpus=float(row[4]) if len(row) > 4 and row[4] else 1.0,
            )


def synthesize_trace(
    num_machines: int,
    num_tasks: int,
    duration_s: float = 600.0,
    mean_runtime_s: float = 120.0,
    seed: int = 0,
    machine_churn: float = 0.0,
    outage_s: float = 60.0,
    burst_spike: float = 0.0,
    burst_count: int = 0,
    burst_s: float = 30.0,
    correlated_outages: int = 0,
    outage_block: int = 0,
) -> Tuple[List[TraceMachineEvent], List[TraceTaskEvent]]:
    """Fabricate machine/task event streams in the clusterdata-2011
    schema: machines ADD at t=0, Poisson task arrivals, exponential
    runtimes emitting SUBMIT then FINISH. A `machine_churn` fraction of
    machines additionally suffers a mid-trace outage (REMOVE, then ADD
    ~outage_s later — the real trace's dominant machine-event pattern),
    so replay exercises eviction + rescheduling, not just placement.
    Defaults to 0 so seeded streams stay reproducible for existing
    callers; opt in explicitly (the churn draws precede the arrival
    draws, so enabling it changes the whole stream for a seed).

    BURST statistics (the real trace's arrival spikes,
    which steady Poisson streams never produce): `burst_count` windows
    of `burst_s` seconds carry arrival intensity `burst_spike`x the
    base rate (spikes >= 5x mean are the regime of interest); the total
    task count stays `num_tasks`, redistributed between burst and base
    time. `correlated_outages` additionally drops `outage_block`
    machines SIMULTANEOUSLY (a rack/power-domain failure, vs
    machine_churn's independent outages), each block restored after
    ~outage_s."""
    rng = np.random.default_rng(seed)
    machines = [
        TraceMachineEvent(time_us=0, machine_id=m + 1, event_type=MACHINE_ADD)
        for m in range(num_machines)
    ]
    n_churn = int(num_machines * machine_churn)
    if n_churn:
        down = rng.choice(num_machines, n_churn, replace=False)
        downtimes = rng.uniform(0.1 * duration_s, 0.8 * duration_s, n_churn)
        for m, t_down in zip(down, downtimes):
            t0 = int(t_down * 1e6)
            machines.append(
                TraceMachineEvent(time_us=t0, machine_id=int(m) + 1,
                                  event_type=MACHINE_REMOVE)
            )
            back = t0 + int(rng.exponential(outage_s) * 1e6)
            if back < duration_s * 1e6:
                machines.append(
                    TraceMachineEvent(time_us=back, machine_id=int(m) + 1,
                                      event_type=MACHINE_ADD)
                )
        machines.sort(key=lambda e: e.time_us)
    if correlated_outages and outage_block:
        for _ in range(correlated_outages):
            t0 = int(rng.uniform(0.15 * duration_s, 0.85 * duration_s) * 1e6)
            block = rng.choice(num_machines, outage_block, replace=False)
            back = t0 + int(rng.exponential(outage_s) * 1e6)
            for m in block:
                machines.append(
                    TraceMachineEvent(time_us=t0, machine_id=int(m) + 1,
                                      event_type=MACHINE_REMOVE)
                )
                if back < duration_s * 1e6:
                    machines.append(
                        TraceMachineEvent(time_us=back, machine_id=int(m) + 1,
                                          event_type=MACHINE_ADD)
                    )
        machines.sort(key=lambda e: e.time_us)
    if burst_spike > 0 and burst_count > 0:
        # piecewise-constant intensity: burst windows at spike x base
        starts = np.sort(
            rng.uniform(0, duration_s - burst_s, burst_count)
        )
        f = burst_count * burst_s / duration_s
        share = burst_spike * f / (burst_spike * f + max(1e-9, 1.0 - f))
        n_burst = int(num_tasks * share)
        base = rng.uniform(0, duration_s * 1e6, num_tasks - n_burst)
        which = rng.integers(0, burst_count, n_burst)
        inside = rng.uniform(0, burst_s * 1e6, n_burst)
        burst_t = starts[which] * 1e6 + inside
        arrivals = np.sort(
            np.concatenate([base, burst_t])
        ).astype(np.int64)
    else:
        arrivals = np.sort(
            rng.uniform(0, duration_s * 1e6, num_tasks)
        ).astype(np.int64)
    runtimes = (rng.exponential(mean_runtime_s, num_tasks) * 1e6).astype(np.int64)
    jobs = rng.integers(1, max(2, num_tasks // 50), num_tasks)
    events: List[TraceTaskEvent] = []
    for i in range(num_tasks):
        events.append(
            TraceTaskEvent(
                time_us=int(arrivals[i]),
                job_id=int(jobs[i]),
                task_index=i,
                event_type=SUBMIT,
                scheduling_class=int(rng.integers(0, 4)),
                cpu_req=float(rng.uniform(0.01, 0.5)),
            )
        )
        events.append(
            TraceTaskEvent(
                time_us=int(arrivals[i] + runtimes[i]),
                job_id=int(jobs[i]),
                task_index=i,
                event_type=FINISH,
                scheduling_class=0,
            )
        )
    events.sort(key=lambda e: e.time_us)
    return machines, events


def iter_windows(
    task_events: Iterable[TraceTaskEvent],
    window_s: float,
    machine_events_until=None,
    max_rounds: Optional[int] = None,
) -> Iterator[List[TraceTaskEvent]]:
    """Batch a timestamp-ordered task-event stream into scheduling
    windows (the trace analogue of the reference's 2s pod-batch
    debounce, k8sclient/client.go:153-193). Yields one STREAM-ORDERED
    event list per non-empty window — submits and finish-kind events
    interleaved as the trace carries them, so window_net_ops can
    replay each task's intra-window lifecycle exactly; calls
    `machine_events_until(t_us)` before each yield so the caller can
    drain machine events up to the window boundary. ONE definition
    shared by the host and device replay drivers so their windowing
    protocols cannot drift."""
    window_us = int(window_s * 1e6)
    pending: List[TraceTaskEvent] = []
    window_end = None
    rounds = 0
    for ev in task_events:
        if window_end is None:
            window_end = ev.time_us + window_us
            if machine_events_until is not None:
                machine_events_until(ev.time_us)
        while ev.time_us >= window_end:
            if pending:
                if machine_events_until is not None:
                    machine_events_until(window_end)
                yield pending
                pending = []
                rounds += 1
                if max_rounds is not None and rounds >= max_rounds:
                    return
            window_end += window_us
        if ev.event_type == SUBMIT or ev.event_type in (
            FINISH, KILL, FAIL, LOST, EVICT
        ):
            pending.append(ev)
    if pending:
        yield pending


def window_net_ops(events: List[TraceTaskEvent], is_live):
    """Collapse one window's events into their NET per-task effect by
    replaying each task's events in stream order against its
    window-start liveness (`is_live(key) -> bool`). Batching a window
    into one scheduling round loses intra-window interleaving; this
    automaton is the single place that semantics lives, shared by the
    host and device drivers so they cannot disagree on duplicate-
    SUBMIT/FINISH interleavings.

    Per key, in order: a SUBMIT while live is the reference's
    duplicate-pod skip (cmd/k8sscheduler/scheduler.go:133-136); a
    finish-kind event while dead targets an unknown task and is
    dropped; otherwise submits open a row and finishes close one —
    the pre-existing row first, then in-window rows.

    Returns (retires, admits, pairs):
      retires: keys whose PRE-EXISTING row completes this window
      admits:  SUBMIT events whose new row survives the window
      pairs:   SUBMIT events admitted AND finished inside the window
               (a full lifecycle per entry — possibly several per key)
    """
    seq: Dict[Tuple[int, int], List[TraceTaskEvent]] = {}
    order: List[Tuple[int, int]] = []
    for ev in events:
        key = (ev.job_id, ev.task_index)
        if key not in seq:
            seq[key] = []
            order.append(key)
        seq[key].append(ev)
    retires: List[Tuple[int, int]] = []
    admits: List[TraceTaskEvent] = []
    pairs: List[TraceTaskEvent] = []
    for key in order:
        pre_live = bool(is_live(key))
        cur_live = pre_live
        pre_row_live = pre_live
        open_submit: Optional[TraceTaskEvent] = None
        for ev in seq[key]:
            if ev.event_type == SUBMIT:
                if cur_live:
                    continue  # duplicate-pod skip
                cur_live = True
                open_submit = ev
            else:
                if not cur_live:
                    continue  # finish for an unknown/dead task
                cur_live = False
                if pre_row_live:
                    retires.append(key)
                    pre_row_live = False
                else:
                    pairs.append(open_submit)
                open_submit = None
        if cur_live and open_submit is not None:
            admits.append(open_submit)
        # cur_live with no open submit: the pre-existing row survives
    return retires, admits, pairs


@dataclass
class ReplayStats:
    rounds: int = 0
    submitted: int = 0
    finished: int = 0
    placed: int = 0
    evicted: int = 0  # tasks displaced by machine REMOVE events
    round_latencies_s: List[float] = field(default_factory=list)
    #: per round: (tasks placed, tasks left unscheduled, tasks evicted
    #: since the round before, the round's timing spans)
    round_log: List[tuple] = field(default_factory=list)

    @property
    def p50_ms(self) -> float:
        if not self.round_latencies_s:
            return 0.0
        return float(np.percentile(self.round_latencies_s, 50) * 1e3)


class TraceReplayDriver:
    """Replays a trace through the host bulk array scheduler
    (scheduler/bulk.py BulkCluster), one window and one round at a
    time.

    The cluster's machine-index space covers every machine_id that ever
    appears; machines toggle in/out of service at their trace timestamps
    (ADD/REMOVE → BulkCluster.set_machine_enabled — the elastic
    membership path; a mid-trace REMOVE evicts its running tasks for
    rescheduling). Tasks flow SUBMIT → (round places) → FINISH/KILL.
    Window size is simulated time per scheduling round. `backend` is
    the flow solver of the rounds (a LayeredTransportSolver takes the
    dense fast path); by default a LayeredTransportSolver on the card,
    which raises where no CUDA device is present. The JAX package's
    default, the host C++ NativeSolver, is one to pass explicitly.
    """

    def __init__(
        self,
        machine_events: Iterable[TraceMachineEvent],
        backend=None,
        slots_per_machine: int = 8,
        num_jobs_hint: int = 64,
        task_capacity: int = 1 << 17,
    ) -> None:
        from ..scheduler.bulk import BulkCluster
        from ..solver.layered import LayeredTransportSolver

        self._machine_events = sorted(machine_events, key=lambda e: e.time_us)
        self._machine_index: Dict[int, int] = {}
        for ev in self._machine_events:
            if ev.machine_id not in self._machine_index:
                self._machine_index[ev.machine_id] = len(self._machine_index)
        self.num_machines = len(self._machine_index)
        self.cluster = BulkCluster(
            num_machines=self.num_machines,
            pus_per_machine=1,
            slots_per_pu=slots_per_machine,
            num_jobs=num_jobs_hint,
            backend=backend or LayeredTransportSolver(device="cuda"),
            num_task_classes=4,  # the trace's scheduling_class domain
            task_capacity=task_capacity,
        )
        # Everything starts out of service; time-0 ADDs enable in replay.
        self.cluster.machine_enabled[:] = False
        self._machine_cursor = 0
        self.num_jobs = num_jobs_hint
        # (trace job_id, task_index) -> bulk task row id
        self._live_tasks: Dict[Tuple[int, int], int] = {}

    def _apply_machine_events_until(self, time_us: int, stats: "ReplayStats") -> None:
        while (
            self._machine_cursor < len(self._machine_events)
            and self._machine_events[self._machine_cursor].time_us <= time_us
        ):
            ev = self._machine_events[self._machine_cursor]
            self._machine_cursor += 1
            idx = self._machine_index[ev.machine_id]
            if ev.event_type == MACHINE_ADD:
                self.cluster.set_machine_enabled(idx, True)
            elif ev.event_type == MACHINE_REMOVE:
                evicted = self.cluster.set_machine_enabled(idx, False)
                stats.evicted += len(evicted)

    def replay(
        self,
        task_events: Iterable[TraceTaskEvent],
        window_s: float = 5.0,
        max_rounds: Optional[int] = None,
    ) -> ReplayStats:
        stats = ReplayStats()
        evicted_before = 0  # stats.evicted at the round before

        def flush_window(events):
            nonlocal evicted_before
            t0 = time.perf_counter()
            # Net per-task window effect from the shared automaton
            # (window_net_ops): pre-existing rows that complete, new
            # rows that survive, and full in-window lifecycles (pairs)
            # — the host path expresses a pair exactly: admit, then
            # complete before the round runs.
            retires, admits, pairs = window_net_ops(
                events, lambda k: k in self._live_tasks
            )
            done_rows = [self._live_tasks.pop(k) for k in retires]
            if done_rows:
                self.cluster.complete_tasks(np.asarray(done_rows, np.int32))
                stats.finished += len(done_rows)
            fresh = admits + pairs
            if fresh:
                jobs = np.asarray(
                    [ev.job_id % self.num_jobs for ev in fresh], np.int32
                )
                classes = np.asarray(
                    [ev.scheduling_class % 4 for ev in fresh], np.int32
                )
                abs_rows = self.cluster.add_tasks(len(fresh), jobs, classes)
                for ev, row in zip(admits, abs_rows[: len(admits)]):
                    self._live_tasks[(ev.job_id, ev.task_index)] = int(row)
                stats.submitted += len(fresh)
                pair_rows = np.asarray(abs_rows[len(admits):], np.int32)
                if len(pair_rows):
                    self.cluster.complete_tasks(pair_rows)
                    stats.finished += len(pair_rows)
            result = self.cluster.round()
            stats.round_latencies_s.append(time.perf_counter() - t0)
            stats.round_log.append((
                len(result.placed_tasks), int(result.num_unscheduled),
                stats.evicted - evicted_before, result.timing))
            evicted_before = stats.evicted
            stats.placed += len(result.placed_tasks)
            stats.rounds += 1

        for events in iter_windows(
            task_events, window_s,
            machine_events_until=lambda t: self._apply_machine_events_until(
                t, stats
            ),
            max_rounds=max_rounds,
        ):
            flush_window(events)
        return stats


class DeviceTraceReplayDriver:
    """Trace replay on the device-resident path at full trace scale.

    The host TraceReplayDriver above round-trips host and device every
    window (admit, solve, fetch, complete). This driver batches instead:
    `stage()` turns the whole event stream into fixed-width per-window
    arrays (admissions, completions, machine toggles) on the host, and
    `replay()` hands them to DeviceBulkCluster.run_replay_rounds, which
    copies them to the device once and chains the K rounds there — the
    reference's event loop (cmd/k8sscheduler/scheduler.go:120-188)
    without a host round-trip per window.

    Row assignment is predicted by a HOST MIRROR of the live bitmap:
    the device admit fills the first `count` free rows in ascending
    row order (a deterministic rule), so the host can track
    (job_id, task_index) -> row without ever reading device state.

    Policy (default): 4 task classes (the trace's scheduling_class
    domain) and per-job unscheduled costs (graph_manager.go:1291-1305)
    — the per-job row-constant shape, solved by the exact closed form.

    Policy (class_cost_fn given): the same 4-class admission stream
    priced by a census-dependent interference model (the CoCo/Whare
    device twins, costmodels/device_costs.py) — rows are NOT
    machine-uniform, so every window runs the real iterative transport
    at full trace width [C, M]: kernel B1 on the card. The reference
    hands whatever graph the policy builds to Flowlessly
    (scheduling/flow/placement/solver.go:60-90); the closed-form default
    above never exercises that path. The cluster lives on `device` (the
    card by default; raises when there is none)."""

    def __init__(
        self,
        machine_events: Iterable[TraceMachineEvent],
        slots_per_machine: int = 8,
        num_jobs_hint: int = 64,
        task_capacity: int = 1 << 15,
        decode_width: int = 4096,
        class_cost_fn=None,
        unsched_cost: int = 5,
        supersteps: Optional[int] = None,
        device="cuda",
    ) -> None:
        import torch

        from ..scheduler.device_bulk import DeviceBulkCluster

        self._machine_events = sorted(machine_events, key=lambda e: e.time_us)
        self._machine_index: Dict[int, int] = {}
        for ev in self._machine_events:
            if ev.machine_id not in self._machine_index:
                self._machine_index[ev.machine_id] = len(self._machine_index)
        self.num_machines = len(self._machine_index)
        self.num_jobs = num_jobs_hint
        self.Tcap = int(task_capacity)
        common = dict(
            num_machines=self.num_machines, pus_per_machine=1,
            slots_per_pu=slots_per_machine, num_jobs=num_jobs_hint,
            num_task_classes=4, task_capacity=self.Tcap, ec_cost=0,
            decode_width=decode_width, device=device,
        )
        if class_cost_fn is None:
            # distinct per-job escape costs (u_j > e = 0 so placement
            # always profits): the row-constant per-job shape
            job_u = 1 + (np.arange(num_jobs_hint, dtype=np.int64) % 8)
            self.cluster = DeviceBulkCluster(job_unsched_cost=job_u, **common)
            assert self.cluster.row_constant, (
                "trace policy must take the closed form"
            )
        else:
            # census-priced classes: G = C = 4 transport rows over the
            # full machine axis, solved iteratively every window
            self.cluster = DeviceBulkCluster(
                unsched_cost=unsched_cost, class_cost_fn=class_cost_fn,
                supersteps=supersteps, **common,
            )
            assert not self.cluster.row_constant and (
                not self.cluster.class_degenerate
            ), "class_cost_fn must force the iterative transport"
        # everything starts out of service; time-0 ADDs enable in stage()
        self.cluster.state = self.cluster.state._replace(
            machine_enabled=torch.zeros(self.num_machines, dtype=torch.bool,
                                        device=self.cluster.device)
        )

    def stage(
        self,
        task_events: Iterable[TraceTaskEvent],
        window_s: float = 5.0,
        max_rounds: Optional[int] = None,
    ) -> dict:
        """Batch events into per-window arrays via the shared
        iter_windows protocol; returns the schedule dict
        run_replay_rounds takes, with staging metadata (rounds,
        submits, finishes, toggles).

        Window semantics come from the shared window_net_ops automaton
        (exact intra-window lifecycle replay, agreeing with the host
        driver by construction). The device round applies toggles ->
        completions -> admissions, so a PAIR (a task admitted AND
        finished inside one window) cannot complete in its own round
        — its row is admitted this round and carried to complete in
        the NEXT round, preserving the submit/finish counts the host
        driver reports."""
        live = np.zeros(self.Tcap, bool)  # host mirror of the live bitmap
        row_of: Dict[Tuple[int, int], int] = {}
        machine_cursor = 0

        windows: List[dict] = []
        pending_toggles: Dict[int, bool] = {}  # dedup keep-last per window
        carry_rows: List[int] = []  # pair rows retiring next window
        submitted = finished = dropped = 0

        def machine_events_until(t_us):
            nonlocal machine_cursor
            while (
                machine_cursor < len(self._machine_events)
                and self._machine_events[machine_cursor].time_us <= t_us
            ):
                ev = self._machine_events[machine_cursor]
                machine_cursor += 1
                idx = self._machine_index[ev.machine_id]
                if ev.event_type == MACHINE_ADD:
                    pending_toggles[idx] = True
                elif ev.event_type == MACHINE_REMOVE:
                    pending_toggles[idx] = False

        def flush_window(events):
            nonlocal carry_rows, pending_toggles
            nonlocal submitted, finished, dropped
            # Net per-task window effect (shared window_net_ops
            # automaton — identical semantics to the host driver).
            # Completions first in the mirror (matching the device
            # round's order): pre-existing retires + pair rows carried
            # from the previous window.
            retires, admits, pairs = window_net_ops(
                events, lambda k: k in row_of
            )
            done_rows = list(carry_rows)
            for key in retires:
                row = row_of.pop(key)
                done_rows.append(row)
            for row in done_rows:
                live[row] = False
            carry_rows = []
            finished += len(done_rows)
            # admissions: first n free rows, ascending — the admit
            # rule. Surviving admits first, then pair rows (admitted
            # now, completed next round via the carry), so capacity
            # pressure drops pairs before durable tasks.
            fresh = admits + pairs
            free = np.nonzero(~live)[0]
            n_adm = min(len(fresh), len(free))
            dropped += len(fresh) - n_adm
            rows = free[:n_adm]
            adm = []
            for i, (ev, row) in enumerate(zip(fresh[:n_adm], rows)):
                live[row] = True
                if i < len(admits):
                    row_of[(ev.job_id, ev.task_index)] = int(row)
                else:
                    # completes NEXT round via the carry (counted in
                    # `finished` when its done_rows entry lands)
                    carry_rows.append(int(row))
                adm.append(
                    (ev.job_id % self.num_jobs, ev.scheduling_class % 4)
                )
            submitted += n_adm
            windows.append(
                dict(
                    adm=adm,
                    done=done_rows,
                    toggles=sorted(pending_toggles.items()),
                )
            )
            pending_toggles = {}

        for events in iter_windows(
            task_events, window_s,
            machine_events_until=machine_events_until,
            max_rounds=max_rounds,
        ):
            flush_window(events)
        if carry_rows and (max_rounds is None or len(windows) < max_rounds):
            # trace ended with carried pair rows: one extra
            # completion-only window retires them
            flush_window([])
        if not windows:
            raise ValueError(
                "trace yielded no schedulable windows (no task events, "
                "or only finishes for unknown tasks)"
            )

        K = len(windows)
        Amax = max(1, max(len(w["adm"]) for w in windows))
        Dmax = max(1, max(len(w["done"]) for w in windows))
        Emax = max(1, max(len(w["toggles"]) for w in windows))
        sch = {
            "adm_job": np.zeros((K, Amax), np.int32),
            "adm_cls": np.zeros((K, Amax), np.int32),
            "adm_grp": np.zeros((K, Amax), np.int32),
            "adm_n": np.zeros(K, np.int32),
            "done_rows": np.full((K, Dmax), self.Tcap, np.int32),
            "done_n": np.zeros(K, np.int32),
            "tog_idx": np.zeros((K, Emax), np.int32),
            "tog_on": np.zeros((K, Emax), bool),
            "tog_n": np.zeros(K, np.int32),
            "rounds": K,
            "submitted": submitted,
            "finished": finished,
            "dropped": dropped,
        }
        for i, w in enumerate(windows):
            sch["adm_n"][i] = len(w["adm"])
            for j, (job, cls) in enumerate(w["adm"]):
                sch["adm_job"][i, j] = job
                sch["adm_cls"][i, j] = cls
            sch["done_n"][i] = len(w["done"])
            sch["done_rows"][i, : len(w["done"])] = w["done"]
            sch["tog_n"][i] = len(w["toggles"])
            for j, (idx, on) in enumerate(w["toggles"]):
                sch["tog_idx"][i, j] = idx
                sch["tog_on"][i, j] = on
        return sch

    def replay(self, schedule: dict, seed: int = 0):
        """Run a staged schedule (or a slice of its windows); returns
        the un-fetched stacked stats."""
        return self.cluster.run_replay_rounds(schedule, seed=seed)
