"""Scheduler service + CLI: the main-binary equivalent.

Reference: cmd/k8sscheduler/scheduler.go — flag surface (:31-42),
pod↔task and node↔machine id maps (:44-62), topology init from polled
nodes or fabricated machines (:191-238), and the main loop (:114-189):
batch pods → add tasks → ScheduleAllJobs (the timed region, :146-150) →
diff bindings → walk PU up to its machine (:379-398) → post bindings.

Run on the card: python -m ksched_tpu_torch.cli --fake-machines \
         --num-machines 10 --podgen 100 --one-shot
and on the CPU with --device cpu (every kernel's plain PyTorch version).

Port of ksched_tpu/cli.py.
"""

from __future__ import annotations

import argparse
import pickle
import sys
import threading
import time
import urllib.error
import warnings
from typing import Dict, List, Optional, Tuple

from .cluster import Binding, ClusterAPI, NodeEvent, PodEvent, SyntheticClusterAPI
from .cluster.api import RETRY_STAT_KEYS
from .costmodels import MODEL_REGISTRY, CostModelType
from .obs import metrics as obs_metrics
from .obs.flight import FlightRecorder
from .obs.spans import SpanTracer, span
from .drivers.synthetic import (
    add_machine,
    add_task_to_job,
    build_machine_topology,
    make_coordinator_root,
)
from .runtime.chaos import FaultInjector, delta_counters
from .runtime.degrade import DegradingSolver, LadderExhausted, build_degradation_ladder
from .runtime.failure import HeartbeatMonitor, RoundWatchdog
from .runtime.trace import RoundTracer
from .scheduler import FlowScheduler
from .scheduler.flow_scheduler import RoundTiming
from .solver.select import make_backend
from .utils import (
    ExpBackoff,
    JobMap,
    ResourceMap,
    ResourceStatus,
    TaskMap,
    rand_uint64,
    resource_id_from_string,
)

#: service-checkpoint sidecar version (the scheduler state itself rides
#: in runtime/checkpoint.py's save_scheduler format). v2 adds the warm
#: restore companion (path + ".wal": journal WAL + device-state
#: manifest) and the round/ladder counters; v1 sidecars still load.
SERVICE_CHECKPOINT_VERSION = 2


class SchedulerService:
    """The long-running scheduler process state (reference:
    cmd/k8sscheduler/scheduler.go:44-87), hardened: the configured
    backend rides a degradation ladder (configured → scan-CSR "jax" →
    cpu_ref → NOOP round, runtime/degrade.py), rounds run under a
    deadline watchdog, heartbeat sweeps are integrated into the loop,
    and every fault / retry / degradation is attributed to its round in
    the trace (runtime/trace.py RoundRecord).

    ``device`` is where the default backend (``make_backend("auto")``
    when ``backend`` is None), the ladder's "jax" rung and a
    device-resident mirror run: "cuda" (the default) raises without a
    card, "cpu" runs the plain PyTorch versions."""

    def __init__(
        self,
        api: ClusterAPI,
        max_tasks_per_pu: int = 1000,
        cost_model: CostModelType = CostModelType.TRIVIAL,
        backend=None,
        backend_name: str = "configured",
        degrade: bool = True,
        injector: Optional[FaultInjector] = None,
        tracer: Optional[RoundTracer] = None,
        round_deadline_s: float = 0.0,
        flight: Optional[FlightRecorder] = None,
        span_tracer: Optional[SpanTracer] = None,
        pipeline: bool = False,
        device_resident: bool = False,
        tenant: str = "",
        audit_every: int = 0,
        device="cuda",
        _restored: Optional[Tuple] = None,
    ) -> None:
        self.api = api
        self.injector = injector
        self.tracer = tracer
        self.flight = flight
        self.span_tracer = span_tracer
        #: owning cell label in a multi-tenant service ("" when the
        #: service is the whole process, as before) — stamped onto every
        #: RoundRecord and the service_round span
        self.tenant = tenant
        #: in-flight split-round state (dispatch_round/complete_round,
        #: the multi-tenant loop's seam) — None outside a split round
        self._split: Optional[dict] = None
        #: double-buffered round mode: each round DISPATCHES its solve,
        #: then posts the PREVIOUS round's bindings while the device
        #: crunches, then synchronizes/decodes/applies — so binding
        #: POSTs (and, in run(), the next poll) overlap the in-flight
        #: solve instead of serializing after it. Graph evolution and
        #: placements are bit-identical to the synchronous loop: only
        #: WHEN bindings are posted moves (one dispatch window later),
        #: never what the scheduler computes (tools/soak.py
        #: --verify-loop-parity asserts this under chaos).
        self.pipeline = pipeline
        self.device_resident = device_resident
        self._pending_bindings: List[Binding] = []
        # service-level gauges (inert singletons when obs is disabled)
        reg = obs_metrics.get_registry()
        self._g_pods = reg.gauge("ksched_live_pods", "pods the service tracks")
        self._g_bound = reg.gauge("ksched_bound_tasks", "tasks currently bound")
        self._g_machines = reg.gauge("ksched_machines", "machines in the topology")
        self.watchdog = RoundWatchdog(round_deadline_s)
        self.monitor: Optional[HeartbeatMonitor] = None
        if _restored is None:
            if backend is None:
                backend = make_backend("auto", device=device)
            if degrade:
                backend = build_degradation_ladder(
                    backend, backend_name, injector=injector, device=device)
            self.resource_map = ResourceMap()
            self.job_map = JobMap()
            self.task_map = TaskMap()
            self.root = make_coordinator_root()
            self.resource_map.insert(
                resource_id_from_string(self.root.resource_desc.uuid),
                ResourceStatus(descriptor=self.root.resource_desc, topology_node=self.root),
            )
            self.scheduler = FlowScheduler(
                self.resource_map,
                self.job_map,
                self.task_map,
                self.root,
                max_tasks_per_pu=max_tasks_per_pu,
                cost_model_factory=MODEL_REGISTRY[cost_model],
                backend=backend,
                device_resident=device_resident,
            )
        else:
            # restore path: the scheduler was rebuilt by replaying the
            # checkpoint through the event API (runtime/checkpoint.py)
            self.scheduler, self.resource_map, self.job_map, self.task_map = _restored
            self.root = self.scheduler.resource_topology
        ladder = self.scheduler.solver.backend
        self.ladder: Optional[DegradingSolver] = (
            ladder if isinstance(ladder, DegradingSolver) else None
        )
        #: device-state integrity audit cadence (0 = off): every Nth
        #: export, the placement solver fingerprints the device mirror
        #: against the host journal truth and repairs divergence
        #: through the escalating ladder (runtime/integrity.py)
        self.audit_every = audit_every
        self.scheduler.solver.audit_every = audit_every
        if audit_every and not device_resident:
            warnings.warn(
                "audit_every is set but device_resident is off: the "
                "integrity audit covers the persistent device mirror, "
                "so ZERO audits will run",
                RuntimeWarning,
                stacklevel=2,
            )
        #: True when this service came from restore() via the warm
        #: manifest path (False: fresh start or cold replay fallback)
        self.restored_warm = False
        self.max_tasks_per_pu = max_tasks_per_pu
        # Bidirectional id maps (reference :44-62).
        self.pod_to_task: Dict[str, int] = {}
        self.task_to_pod: Dict[int, str] = {}
        self.node_to_machine: Dict[str, int] = {}
        self.machine_to_node: Dict[int, str] = {}
        # One job shelters every pod-task (reference :118, :241-257).
        self.job_id = rand_uint64()
        self.old_bindings: Dict[int, int] = {}
        self.round_latencies_s: list = []
        self.noop_rounds = 0
        #: whether the runnable backlog may need a re-solve on a quiet
        #: poll (set by NOOP rounds and heartbeat evictions; cleared by
        #: a successful solve) — run() consults it so steady-state idle
        #: polls cost a sweep, not a full MCMF solve
        self.backlog_dirty = False
        # Persistent attribution marks: faults/retries can fire between
        # rounds (e.g. at batch-poll time, before run_round is entered),
        # and must land in the NEXT round's record, never vanish.
        self._fault_mark: Dict[str, int] = (
            injector.snapshot() if injector is not None else {}
        )
        self._api_stats_mark: Dict[str, int] = (
            api.stats() if hasattr(api, "stats") else {}
        )

    # -- topology ---------------------------------------------------------

    def add_node(self, node: NodeEvent) -> None:
        machine = add_machine(
            self.scheduler,
            self.resource_map,
            self.root,
            num_cores=node.num_cores,
            pus_per_core=node.pus_per_core,
            task_capacity_per_pu=self.max_tasks_per_pu,
            machine_index=len(self.node_to_machine),
        )
        machine.resource_desc.capacity.net_bw = node.net_bw_capacity
        mid = resource_id_from_string(machine.resource_desc.uuid)
        self.node_to_machine[node.node_id] = mid
        self.machine_to_node[mid] = node.node_id
        # fresh capacity: wake the quiet-channel loop for a re-solve —
        # waiting unbound pods must not starve until a new pod arrives
        if self._has_unbound_pods():
            self.backlog_dirty = True

    def init_topology(
        self,
        fake_machines: int = 0,
        node_batch_timeout_s: float = 2.0,
        cores_per_machine: int = 1,
        pus_per_core: int = 1,
    ) -> int:
        """Fabricate machines (-fakeMachines, reference :191-202) or poll
        the control plane for nodes (:206-238)."""
        if fake_machines > 0:
            for i in range(fake_machines):
                self.add_node(
                    NodeEvent(
                        node_id=f"fake_node_{i}",
                        num_cores=cores_per_machine,
                        pus_per_core=pus_per_core,
                    )
                )
            return fake_machines
        nodes = self.api.get_node_batch(node_batch_timeout_s)
        for node in nodes:
            self.add_node(node)
        return len(nodes)

    def enable_heartbeats(
        self,
        machine_timeout_s: float = 30.0,
        task_timeout_s: float = 60.0,
        clock=None,
    ) -> HeartbeatMonitor:
        """Attach a HeartbeatMonitor; run_round then sweeps it every
        round and cleans the node maps for machines it expires."""
        self.monitor = HeartbeatMonitor(
            self.scheduler,
            machine_timeout_s=machine_timeout_s,
            task_timeout_s=task_timeout_s,
            clock=clock,
        )
        return self.monitor

    def _has_unbound_pods(self) -> bool:
        """Known pods whose tasks hold no binding — the backlog fresh
        node capacity may now admit. O(live pods): fine on the rare
        node-arrival path, too hot for per-completion use."""
        bound = self.scheduler.task_bindings
        return any(tid not in bound for tid in self.pod_to_task.values())

    def _forget_machine(self, machine_rid: int) -> None:
        """Drop a lost machine from the node↔machine maps (the scheduler
        side was already deregistered by the heartbeat sweep)."""
        node_id = self.machine_to_node.pop(machine_rid, None)
        if node_id is not None and self.node_to_machine.get(node_id) == machine_rid:
            del self.node_to_machine[node_id]

    def complete_pod(self, pod_id: str) -> bool:
        """Retire a pod's task through the normal completion path and
        clean the service maps. False if the pod is unknown or its task
        is not currently bound (nothing to complete)."""
        task_id = self.pod_to_task.get(pod_id)
        if task_id is None or task_id not in self.scheduler.task_bindings:
            return False
        td = self.task_map.find(task_id)
        self.scheduler.handle_task_completion(td)
        self.pod_to_task.pop(pod_id, None)
        self.task_to_pod.pop(task_id, None)
        self.old_bindings.pop(task_id, None)
        # freed capacity may admit waiting unbound pods: wake the
        # quiet-channel loop for a re-solve. Unconditional — a spurious
        # re-solve on the next quiet poll is near-free, while scanning
        # for unbound pods here would make bulk completion bursts O(n²).
        self.backlog_dirty = True
        return True

    # -- pod → task -------------------------------------------------------

    def _add_pod(self, pod: PodEvent) -> None:
        existing = self.pod_to_task.get(pod.pod_id)
        if existing is not None:
            # Re-delivered pod: keep the existing task — a duplicate
            # would double-occupy capacity — and forget the emitted
            # binding so the next round's diff re-posts it. Two causes:
            # a failed binding POST (spec unchanged), or a pod deleted
            # and re-created under the same name (the watch reconcile
            # re-surfaces it). For the latter the new spec must win:
            # refresh the descriptor, and evict any stale placement so
            # the next round reschedules under the new request.
            td = self.task_map.find(existing)
            if td is not None and (
                td.resource_request.cpu_cores,
                td.resource_request.net_bw,
                int(td.task_type),
            ) != (pod.cpu_request, pod.net_bw_request, pod.task_class):
                td.resource_request.cpu_cores = pod.cpu_request
                td.resource_request.net_bw = pod.net_bw_request
                td.task_type = type(td.task_type)(pod.task_class)
                rid = self.scheduler.task_bindings.get(existing)
                if rid is not None:
                    rs = self.resource_map.find(rid)
                    self.scheduler.handle_task_eviction(td, rs.descriptor)
            self.old_bindings.pop(existing, None)
            return
        td = add_task_to_job(self.job_id, self.job_map, self.task_map, name=pod.pod_id)
        td.resource_request.cpu_cores = pod.cpu_request
        td.resource_request.net_bw = pod.net_bw_request
        td.task_type = type(td.task_type)(pod.task_class)
        # Leave state CREATED: the scheduler's runnable-task computation
        # promotes CREATED→RUNNABLE and registers the task (reference:
        # flowscheduler/scheduler.go:487-529).
        self.pod_to_task[pod.pod_id] = td.uid
        self.task_to_pod[td.uid] = pod.pod_id

    def _find_parent_machine(self, pu_rid: int) -> Optional[int]:
        """Walk a PU up the topology to its machine (reference :379-398)."""
        rs = self.resource_map.find(pu_rid)
        while rs is not None:
            if resource_id_from_string(rs.descriptor.uuid) in self.machine_to_node:
                return resource_id_from_string(rs.descriptor.uuid)
            if not rs.topology_node.parent_id:
                return None
            rs = self.resource_map.find(resource_id_from_string(rs.topology_node.parent_id))
        return None

    # -- the main loop ----------------------------------------------------

    def _collect_bindings(self) -> List[Binding]:
        """Diff the scheduler's bindings against what was last emitted
        and translate new/changed ones into pod→node bindings."""
        new_bindings = self.scheduler.get_task_bindings()
        out = []
        for task_id, pu_rid in new_bindings.items():
            if self.old_bindings.get(task_id) == pu_rid:
                continue
            machine_rid = self._find_parent_machine(pu_rid)
            if machine_rid is None:
                continue
            pod_id = self.task_to_pod.get(task_id)
            if pod_id is None:
                continue
            out.append(Binding(pod_id=pod_id, node_id=self.machine_to_node[machine_rid]))
        self.old_bindings = dict(new_bindings)
        return out

    def flush_pending_bindings(self) -> int:
        """POST the previous pipelined round's bindings. Called inside
        the next round's dispatch window (so the HTTP round-trips
        overlap the in-flight solve), by idle sweeps (a quiet channel
        must not strand the last active round's POSTs), and by
        run()/save_checkpoint at loop exit so no binding is ever left
        unposted. A failed POST restores the batch for retry at the
        next flush point instead of dropping it."""
        out, self._pending_bindings = self._pending_bindings, []
        if out:
            try:
                with span("bindings_post", n=len(out)):
                    self.api.assign_bindings(out)
            except BaseException:
                self._pending_bindings = out + self._pending_bindings
                raise
        return len(out)

    def run_once(self, pods) -> int:
        """One iteration of the reference loop body (:120-187). Returns
        the number of new bindings pushed (queued, in pipeline mode)."""
        for pod in pods:
            self._add_pod(pod)
        jd = self.job_map.find(self.job_id)
        if jd is not None:
            self.scheduler.add_job(jd)
        if self.pipeline:
            return self._run_once_pipelined()
        t0 = time.perf_counter()
        self.scheduler.schedule_all_jobs()
        self.round_latencies_s.append(time.perf_counter() - t0)
        out = self._collect_bindings()
        if out:
            self.api.assign_bindings(out)
        return len(out)

    def _run_once_pipelined(self) -> int:
        """The double-buffered round body: dispatch this round's solve,
        post the PREVIOUS round's bindings while the device crunches,
        then synchronize/decode/apply and queue this round's bindings
        for the next dispatch window. On a rung failure the ladder
        completes the round synchronously inside finish_scheduling
        (runtime/degrade.py solve_async/complete), and LadderExhausted
        propagates to run_round's NOOP backstop exactly as in the
        synchronous loop."""
        t0 = time.perf_counter()
        token = self.scheduler.schedule_all_jobs_async()
        # overlap window: the in-flight solve hides these POSTs. A
        # POST failure must not leave the dispatched round in flight
        # (every later event handler would refuse forever), so the
        # round is synchronized first and the error re-raised after —
        # with the batch already restored for retry by flush itself.
        flush_err = None
        try:
            self.flush_pending_bindings()
        except BaseException as e:  # noqa: BLE001 — re-raised below;
            # BaseException on purpose: a KeyboardInterrupt landing in
            # the POST must still let the dispatched round synchronize,
            # or the in-flight latch wedges every later event handler
            flush_err = e
        try:
            if token is not None:
                self.scheduler.finish_scheduling()
            else:
                self.scheduler.last_timing = RoundTiming()
        except BaseException as finish_err:
            # the flush error outranks the finish error (a Ctrl-C in
            # the POST must not be swallowed by a LadderExhausted that
            # run_round's NOOP backstop would absorb); the finish
            # failure rides along as the cause
            if flush_err is not None:
                raise flush_err from finish_err
            raise
        self.round_latencies_s.append(time.perf_counter() - t0)
        out = self._collect_bindings()
        self._pending_bindings.extend(out)
        if flush_err is not None:
            raise flush_err
        return len(out)

    def run_round(
        self, pods, now: Optional[float] = None, solve: bool = True
    ) -> int:
        """One hardened round: run_once under the deadline watchdog with
        the degradation ladder's NOOP backstop, then a heartbeat sweep,
        then trace attribution (faults / retries / degradations /
        expiries → this round's RoundRecord). ``now`` is the heartbeat
        sweep's injected clock (the chaos soak drives logical time).

        ``solve=False`` is the idle sweep: heartbeat check + trace
        attribution only, no graph rebuild/solve — run() uses it on
        quiet polls while the backlog is clean, so a steady-state
        service costs a sweep per batch timeout, not a full MCMF
        solve. Recorded with ``solver_rung`` -1 and ``noop_round``
        False (a NOOP is a *failed* solve; this is a skipped one).

        With a span tracer and flight recorder attached, the whole
        round runs under a ``service_round`` span and the round's
        record + span slice are deposited in the flight ring (which
        auto-dumps on a deadline miss or NOOP round)."""
        span_mark = self.span_tracer.mark() if self.span_tracer is not None else 0
        span_args = dict(pods=len(pods), solve=solve)
        if self.tenant:
            span_args["tenant"] = self.tenant
        rec = None
        with span("service_round", **span_args):
            rec, bound = self._run_round_body(pods, now, solve)
        self._note_flight(rec, span_mark)
        return bound

    def _note_flight(self, rec, span_mark: int, span_prefix=None) -> None:
        if self.flight is not None and rec is not None:
            events = (
                self.span_tracer.events_since(span_mark)
                if self.span_tracer is not None
                else None
            )
            if span_prefix:
                events = list(span_prefix) + (events or [])
            self.flight.note_round(rec, events)

    def _run_round_body(self, pods, now, solve):
        deg_mark = self.ladder.degradations_total if self.ladder is not None else 0
        noop = False
        bound = 0
        deadline_miss = False
        if solve:
            with self.watchdog as wd:
                try:
                    bound = self.run_once(pods)
                except LadderExhausted as e:
                    # Every rung failed: keep the previous assignments
                    # and carry on — the backlog stays runnable and the
                    # next round retries from the configured rung.
                    noop = True
                    self.noop_rounds += 1
                    self.scheduler.last_timing = RoundTiming()
                    warnings.warn(
                        f"NOOP round (previous assignments kept): {e}",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            deadline_miss = wd.fired
        else:
            # no solve ran: keep stale phase timings out of the trace
            self.scheduler.last_timing = RoundTiming()
            # a quiet channel must not strand the last active round's
            # deferred POSTs: with no next dispatch window coming, the
            # idle sweep IS the flush point (pipeline mode only; the
            # list is always empty otherwise)
            self.flush_pending_bindings()
        rec = self._round_accounting(noop, bound, deadline_miss, now, solve, deg_mark)
        return rec, bound

    # -- split rounds: the multi-tenant loop's dispatch/complete seam ------

    def dispatch_round(self, pods) -> bool:
        """Phase A of a SPLIT round (tenancy/): ingest the pod
        batch and DISPATCH the solve without synchronizing, so the
        multi-tenant loop can dispatch every cell, flush the shared
        stacked batch ONCE, and only then complete each cell. The
        watchdog starts here and stops in complete_round, so the
        per-tenant deadline covers the cell's whole round (its own
        phases plus its share of the batched-solve window). Returns
        True when a solve was dispatched (runnable work existed)."""
        if self._split is not None:
            raise RuntimeError("a split round is already in flight; call complete_round first")
        st = {
            "deg_mark": self.ladder.degradations_total if self.ladder is not None else 0,
            "t0": time.perf_counter(),
            "pods": len(pods),
        }
        self.watchdog.__enter__()
        try:
            for pod in pods:
                self._add_pod(pod)
            jd = self.job_map.find(self.job_id)
            if jd is not None:
                self.scheduler.add_job(jd)
            st["token"] = self.scheduler.schedule_all_jobs_async()
        except BaseException:
            self.watchdog.__exit__(*sys.exc_info())
            raise
        self._split = st
        return st["token"] is not None

    def complete_round(
        self,
        now: Optional[float] = None,
        span_mark: int = 0,
        span_prefix=None,
    ) -> int:
        """Phase B of a split round: synchronize the lane solve, apply
        deltas, queue/post this round's bindings, then the same
        heartbeat sweep + trace attribution as run_round (a failed
        ladder becomes a NOOP round exactly as in the synchronous
        loop). ``span_mark`` scopes the flight-ring span slice to this
        phase (pass a mark taken at its start); ``span_prefix`` carries
        the cell's OWN dispatch-phase events — in a multiplexed round
        the wall-clock window between a cell's dispatch and complete
        contains every other cell's spans, which must not leak into a
        tenant-scoped flight dump."""
        if self._split is None:
            raise RuntimeError("no split round in flight; call dispatch_round first")
        st, self._split = self._split, None
        noop = False
        bound = 0
        try:
            try:
                if st["token"] is not None:
                    self.scheduler.finish_scheduling()
                else:
                    self.scheduler.last_timing = RoundTiming()
            except LadderExhausted as e:
                noop = True
                self.noop_rounds += 1
                self.scheduler.last_timing = RoundTiming()
                warnings.warn(
                    f"NOOP round (previous assignments kept): {e}",
                    RuntimeWarning,
                    stacklevel=2,
                )
        finally:
            self.watchdog.__exit__(*sys.exc_info())
        deadline_miss = self.watchdog.fired
        self.round_latencies_s.append(time.perf_counter() - st["t0"])
        if not noop:
            out = self._collect_bindings()
            if self.pipeline:
                # per-tenant dispatch window: the POSTs ride the NEXT
                # round's batched-solve window (cell.post_window)
                self._pending_bindings.extend(out)
            elif out:
                self.api.assign_bindings(out)
            bound = len(out)
        # a round with no runnable work (token None) dispatched no
        # solve: record it as an idle sweep (solver_rung -1, zeroed
        # phase timings EXCLUDED from latency percentiles), not as a
        # solved round whose all-zero timings would drag a lightly
        # loaded tenant's published p50 toward zero
        rec = self._round_accounting(
            noop, bound, deadline_miss, now, st["token"] is not None,
            st["deg_mark"],
        )
        self._note_flight(rec, span_mark, span_prefix)
        return bound

    def _round_accounting(self, noop, bound, deadline_miss, now, solve, deg_mark):
        """The post-solve tail every round shape shares (run_round's
        body and the split complete_round): heartbeat sweep, backlog
        flag maintenance, service gauges, and the round's trace record
        with fault/retry/degradation attribution."""
        lost: List[int] = []
        failed: List[int] = []
        if self.monitor is not None:
            lost, failed = self.monitor.check(now)
            for rid in lost:
                self._forget_machine(rid)
        # NOOP rounds and evictions leave runnable work behind; a clean
        # full solve clears it. An idle sweep must not clear the flag —
        # it did not schedule anything.
        if noop or lost or failed:
            self.backlog_dirty = True
        elif solve:
            self.backlog_dirty = False
        self._g_pods.set(len(self.pod_to_task))
        self._g_bound.set(len(self.scheduler.task_bindings))
        self._g_machines.set(len(self.node_to_machine))
        # a state divergence this round already deposited its
        # structured soltel event; make sure a flight dump carries it
        # (rate-limited by the recorder, like the other triggers). The
        # flag is CONSUMED here — idle sweeps never run the gate, so a
        # stale flag would re-trigger dumps for a long-repaired event.
        sol = self.scheduler.solver
        if getattr(sol, "last_divergence", None):
            if self.flight is not None:
                self.flight.trigger("state_divergence")
            sol.last_divergence = None
        rec = None
        if self.tracer is not None:
            faults = {}
            if self.injector is not None:
                snap = self.injector.snapshot()
                faults = delta_counters(self._fault_mark, snap)
                self._fault_mark = snap
            api_stats = self.api.stats() if hasattr(self.api, "stats") else {}
            # Only retry/re-post counters belong in `retries`; the stats
            # surface also carries drop counters (binding_drops), which
            # are a different signal and would silently inflate it.
            retries = sum(
                api_stats.get(k, 0) - self._api_stats_mark.get(k, 0)
                for k in RETRY_STAT_KEYS
            )
            self._api_stats_mark = api_stats
            rec = self.tracer.record_flow_round(
                self.scheduler,
                bound,
                # idle sweeps must not re-report the previous solve's
                # graph-delta stats and solver work (a NOOP round's
                # graph update DID run, so it still reports)
                solved=solve,
                extra=dict(
                    faults_injected=faults,
                    retries=retries,
                    degradations=(
                        self.ladder.degradations_total - deg_mark
                        if self.ladder is not None
                        else 0
                    ),
                    solver_rung=(
                        -1 if (noop or not solve)
                        else (self.ladder.last_rung if self.ladder is not None else 0)
                    ),
                    noop_round=noop,
                    deadline_miss=deadline_miss,
                    machines_lost=len(lost),
                    tasks_failed=len(failed),
                    tenant=self.tenant,
                ),
            )
        return rec

    def run(self, pod_batch_timeout_s: float = 2.0, max_rounds: Optional[int] = None) -> None:
        """The hardened main loop. Exits only when the control plane is
        actually closed; an empty batch with the channel still open —
        the signature of a transient API-server outage (or plain quiet)
        — idles through a sweep-only round instead of exiting, so the
        scheduler rides out outages and still detects silent machines
        while no pods arrive. Idle rounds do not count against
        ``max_rounds`` (which counts scheduling rounds, as before)."""
        rounds = 0
        tick = 0  # injector rounds: one per loop iteration, idle or not
        while max_rounds is None or rounds < max_rounds:
            if self.injector is not None:
                # `tick`, not `rounds`: an idle round is still one full
                # pass (poll + run_round), so outage windows must count
                # down and fault draws advance exactly once per
                # iteration — re-passing a stale index would re-roll the
                # same round's draws every poll during an outage.
                self.injector.begin_round(tick)
            tick += 1
            pods = self.api.poll_pod_batch(pod_batch_timeout_s)
            if not pods:
                if self.api.is_closed():
                    break  # control plane closed: clean shutdown
                # Transient outage / quiet channel: sweep-only idle
                # round — unless a NOOP round or an eviction left
                # runnable backlog behind, in which case this quiet
                # poll is the moment to re-solve it.
                self.run_round([], solve=self.backlog_dirty)
                continue
            self.run_round(pods)
            rounds += 1
        # pipelined loops defer each round's POSTs into the next
        # dispatch window; the last round's must not be stranded
        self.flush_pending_bindings()

    # -- service checkpoint (scheduler state + the id maps) ----------------

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the service: the scheduler's world state (via
        runtime/checkpoint.py, written to ``path + ".sched"``) plus the
        service-owned id maps and round bookkeeping as a sidecar at
        ``path`` — everything a restarted process needs to keep serving
        the same pods against the same nodes. Additionally writes the
        WARM manifest at ``path + ".wal"`` (journal WAL + device-state
        manifest + solver warm endpoints + ladder counters) so
        restore() can resume on the delta-sized warm path instead of
        the cold full_build; a damaged/missing manifest degrades
        restore to the cold event replay, never blocks it."""
        import os

        from .runtime.checkpoint import (
            atomic_pickle,
            save_scheduler,
            save_warm_manifest,
        )

        # bindings queued for the next pipelined dispatch window would
        # not survive the restart; post them before snapshotting
        self.flush_pending_bindings()
        save_scheduler(self.scheduler, path + ".sched")
        # per-CHECKPOINT nonce binding sidecar <-> warm manifest: the
        # job_id is a service-lifetime constant, so it cannot tell a
        # stale .wal (from an earlier save to the same path) apart
        # from this save's. Drawn OUTSIDE the seeded id stream — a
        # seeded draw here would shift every later task uid and break
        # kills-vs-control placement parity in the recovery soak.
        nonce = int.from_bytes(os.urandom(8), "little")
        state = {
            "version": SERVICE_CHECKPOINT_VERSION,
            "ckpt_nonce": nonce,
            "pod_to_task": dict(self.pod_to_task),
            "node_to_machine": dict(self.node_to_machine),
            "job_id": self.job_id,
            "old_bindings": dict(self.old_bindings),
            "max_tasks_per_pu": self.max_tasks_per_pu,
            # round/ladder continuity (the restart-budget/quarantine
            # counters of the manifest; per-tenant via `tenant`)
            "tenant": self.tenant,
            "noop_rounds": self.noop_rounds,
            "degradations_total": (
                self.ladder.degradations_total if self.ladder is not None else 0
            ),
            "backlog_dirty": self.backlog_dirty,
            "audit_every": self.audit_every,
        }
        atomic_pickle(state, path)
        try:
            save_warm_manifest(
                self.scheduler,
                path + ".wal",
                # the nonce binds the manifest to THIS sidecar: restore
                # refuses a stale .wal left by an earlier checkpoint
                # at the same path (job_id rides along for operators)
                meta={
                    "tenant": self.tenant,
                    "job_id": int(self.job_id),
                    "ckpt_nonce": nonce,
                },
            )
        except Exception as e:  # noqa: BLE001 — warm restore is an
            # optimization; an unpicklable cost model (or any manifest
            # writer defect) must not take checkpointing down with it.
            # A PREVIOUS checkpoint's manifest at this path must not
            # survive either: restore would pair the old scheduler
            # state with the new sidecar's id maps.
            try:
                os.remove(path + ".wal")
            except OSError:
                pass
            warnings.warn(
                f"warm manifest not written ({e}); restore will use the "
                "cold event replay",
                RuntimeWarning,
                stacklevel=2,
            )

    @classmethod
    def restore(
        cls,
        api: ClusterAPI,
        path: str,
        cost_model: CostModelType = CostModelType.TRIVIAL,
        backend=None,
        backend_name: str = "configured",
        degrade: bool = True,
        injector: Optional[FaultInjector] = None,
        tracer: Optional[RoundTracer] = None,
        round_deadline_s: float = 0.0,
        flight: Optional[FlightRecorder] = None,
        span_tracer: Optional[SpanTracer] = None,
        pipeline: bool = False,
        device_resident: bool = False,
        audit_every: Optional[int] = None,
        device="cuda",
    ) -> "SchedulerService":
        """Rebuild a service from save_checkpoint output. With an
        intact warm manifest (``path + ".wal"``) the scheduler resumes
        WARM: the device-state manifest is replayed into a rebuilt
        DeviceGraphState/SlotPlanState, the device mirror is primed
        outside any round, and the solver's carried flow/potentials/
        endpoint masks are re-imported — the first post-restore round
        is already delta-sized and its solve warm, bit-identical to
        the never-killed process. A missing or corrupted manifest
        (torn write, dropped/duplicated WAL record, version mismatch)
        is DETECTED and contained: restore warns and falls back to the
        cold event replay. Heartbeat history never survives the
        restart — machines are unmonitored until their next beat (the
        same cold-rebuild property the reference has).

        Damaged inputs raise distinct, actionable errors: a missing or
        garbage sidecar -> CheckpointDamaged, a missing ``.sched``
        companion -> CheckpointMissing, a version mismatch ->
        CheckpointVersionError. ``device`` is as for the constructor."""
        import os

        from .runtime.checkpoint import (
            CheckpointDamaged,
            CheckpointMissing,
            CheckpointVersionError,
            load_warm_manifest,
            restore_scheduler,
        )

        try:
            with open(path, "rb") as f:
                state = pickle.load(f)
        except FileNotFoundError:
            raise
        except Exception as e:  # noqa: BLE001 — classified: damaged bytes
            raise CheckpointDamaged(
                f"service checkpoint sidecar {path} is truncated or not a "
                f"ksched checkpoint ({type(e).__name__}: {e}); restore from "
                "an intact checkpoint or start cold"
            ) from e
        if not isinstance(state, dict) or "version" not in state:
            raise CheckpointDamaged(
                f"service checkpoint sidecar {path} holds no version field "
                "— not a ksched service checkpoint"
            )
        if state["version"] not in (1, SERVICE_CHECKPOINT_VERSION):
            raise CheckpointVersionError(
                f"unsupported service checkpoint version {state['version']} "
                f"(this build reads 1..{SERVICE_CHECKPOINT_VERSION}); "
                "re-checkpoint from a matching build"
            )
        if not os.path.exists(path + ".sched"):
            raise CheckpointMissing(
                f"service checkpoint {path} is missing its scheduler "
                f"companion {path + '.sched'} — the sidecar alone cannot "
                "rebuild the world state; restore both files together"
            )
        if backend is None:
            backend = make_backend("auto", device=device)
        if degrade:
            backend = build_degradation_ladder(
                backend, backend_name, injector=injector, device=device)
        parts = None
        restored_warm = False
        wal_fallback = None  # fallback kind when the manifest was rejected
        wal_path = path + ".wal"
        if os.path.exists(wal_path):
            try:
                parts, meta = load_warm_manifest(
                    wal_path, backend=backend, device_resident=device_resident
                )
                if meta.get("ckpt_nonce") != state.get("ckpt_nonce"):
                    raise CheckpointDamaged(
                        f"warm manifest {wal_path} belongs to a different "
                        f"checkpoint (nonce {meta.get('ckpt_nonce')} != "
                        f"sidecar {state.get('ckpt_nonce')}) — a stale "
                        ".wal from an earlier save at this path"
                    )
                restored_warm = True
            except Exception as e:  # noqa: BLE001 — contained: any
                # manifest damage or rejection degrades to the cold
                # replay; CORRUPTION (torn/dropped/duplicated/bit-rot
                # records) is labelled apart from other rejections
                # (version drift, stale nonce, unpicklable payload) so
                # an operator fleet-upgrading builds doesn't read the
                # restore counter as bit rot
                from .runtime.integrity import WALCorrupted

                parts = None
                wal_fallback = (
                    "wal_corrupt_fallback"
                    if isinstance(e, WALCorrupted)
                    else "wal_rejected_fallback"
                )
                warnings.warn(
                    f"warm manifest {wal_path} rejected ({e}); falling "
                    "back to cold event replay",
                    RuntimeWarning,
                    stacklevel=2,
                )
        if parts is None:
            parts = restore_scheduler(
                path + ".sched",
                cost_model_factory=MODEL_REGISTRY[cost_model],
                backend=backend,
                device_resident=device_resident,
            )
        # mutually exclusive kinds: one restore, one increment
        obs_metrics.get_registry().counter(
            "ksched_restore_total",
            "service restores by path taken",
            labelnames=("kind",),
        ).labels(
            kind="warm" if restored_warm else (wal_fallback or "cold")
        ).inc()
        svc = cls(
            api,
            max_tasks_per_pu=state["max_tasks_per_pu"],
            cost_model=cost_model,
            degrade=False,
            injector=injector,
            tracer=tracer,
            round_deadline_s=round_deadline_s,
            flight=flight,
            span_tracer=span_tracer,
            pipeline=pipeline,
            device_resident=device_resident,
            tenant=state.get("tenant", ""),
            audit_every=(
                audit_every if audit_every is not None
                else state.get("audit_every", 0)
            ),
            device=device,
            _restored=parts,
        )
        svc.restored_warm = restored_warm
        svc.job_id = state["job_id"]
        svc.old_bindings = dict(state["old_bindings"])
        # counters ride the sidecar (v2): ladder/NOOP continuity
        svc.noop_rounds = state.get("noop_rounds", 0)
        if svc.ladder is not None:
            svc.ladder.degradations_total = state.get("degradations_total", 0)
        # Warm restores carry the exact pre-kill backlog flag; a cold
        # replay assumes dirty so the first quiet poll re-solves
        # anything a pre-kill NOOP round or eviction left runnable.
        svc.backlog_dirty = state.get("backlog_dirty", True) if restored_warm else True
        # only tasks that still exist ride along (completed pods whose
        # descriptors were dropped must not resurrect map entries)
        for pod_id, task_id in state["pod_to_task"].items():
            if svc.task_map.find(task_id) is not None:
                svc.pod_to_task[pod_id] = task_id
                svc.task_to_pod[task_id] = pod_id
        for node_id, mid in state["node_to_machine"].items():
            if svc.resource_map.find(mid) is not None:
                svc.node_to_machine[node_id] = mid
                svc.machine_to_node[mid] = node_id
        return svc


def _podgen_transient(e: Exception) -> bool:
    """Transient control-plane errors podgen retries: 5xx (rides in as
    HTTPError) and transport failures — URLError, ConnectionError, and
    TimeoutError are all OSError subclasses, so OSError is the whole
    net. Everything else (auth errors, schema rejections) is fatal."""
    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500
    return isinstance(e, OSError)


def podgen(
    api: ClusterAPI,
    num_pods: int,
    net_bw: int = 0,
    retry_budget: int = 4,
    backoff: Optional[ExpBackoff] = None,
) -> None:
    """Load generator (reference: cmd/podgen/podgen.go:34-74). Against
    an HTTP control plane, pods are created via the API server (as the
    reference's podgen does); against the synthetic one, enqueued
    directly.

    One transient 500 must not take the whole control plane down:
    transient create failures are retried with exponential backoff
    under a budget; only a fatal error (4xx, or a spent budget) warns
    and closes the API — which unblocks get_pod_batch, since the
    remaining pods will never arrive."""
    backoff = backoff or ExpBackoff(max_retries=retry_budget)
    i = 0
    try:
        while i < num_pods:
            try:
                if hasattr(api, "create_pod"):
                    api.create_pod(f"pod_{i}", net_bw_request=net_bw)
                else:
                    api.submit_pod(PodEvent(pod_id=f"pod_{i}", net_bw_request=net_bw))
            except Exception as e:  # noqa: BLE001 — classified below
                delay = backoff.next_delay() if _podgen_transient(e) else None
                if delay is None:
                    raise
                warnings.warn(
                    f"podgen: transient create_pod failure ({e}); retrying",
                    RuntimeWarning,
                    stacklevel=2,
                )
                time.sleep(delay)
                continue
            backoff.reset()
            i += 1
    except Exception as e:  # noqa: BLE001 — runs in a daemon thread
        warnings.warn(
            f"podgen failed fatally after {i}/{num_pods} pods: {e}; "
            "closing the control plane",
            RuntimeWarning,
            stacklevel=2,
        )
        api.close()


def _run_multi_tenant(args, span_tracer, metrics_server) -> int:
    """--tenants N: the scheduler-as-a-service demo path — N synthetic
    cells multiplexed through one warm batched solver (tenancy/), its
    solves on ``args.device``."""
    from .tenancy import MultiTenantService

    tenants = args.tenants
    mts = MultiTenantService(
        round_deadline_s=args.round_deadline,
        pipeline=args.pipeline,
        device_resident=args.device_resident,
        flight_dir=args.flight_dir,
        flight_capacity=args.flight_capacity,
        span_tracer=span_tracer,
        device=args.device,
    )
    per_cell = max(1, args.podgen // tenants) if args.podgen > 0 else 0
    try:
        for i in range(tenants):
            cell = mts.add_tenant(
                f"cell{i}",
                machines=args.num_machines,
                pus_per_core=args.pus_per_core,
                slots=args.max_tasks_per_pu,
                seed=1000 + i,
                machine_timeout_s=args.machine_timeout,
            )
            for j in range(per_cell):
                cell.api.submit_pod(PodEvent(pod_id=f"cell{i}_pod_{j}"))
        print(
            f"tenancy: {tenants} cells x {args.num_machines} machines, "
            f"{per_cell} pods each",
            file=sys.stderr,
        )
        rounds = 0
        while rounds < 512:
            mts.run_round(now=float(rounds))
            rounds += 1
            if per_cell and all(
                len(c.svc.scheduler.task_bindings) >= min(
                    per_cell,
                    args.num_machines * args.pus_per_core * args.max_tasks_per_pu,
                )
                for c in mts.cells.values()
            ):
                break
            if not per_cell and rounds >= 8:
                break
        mts.drain()
        for tid, summary in sorted(mts.tenant_summary().items()):
            bound = len(mts.cells[tid].svc.scheduler.task_bindings)
            print(
                f"{tid}: bound={bound} p50={summary.get('p50_ms', 0):.2f}ms "
                f"p99={summary.get('p99_ms', 0):.2f}ms",
                file=sys.stderr,
            )
        print(
            f"tenancy: {rounds} rounds, "
            f"{mts.batcher.flushes} batch flushes, last round "
            f"{mts.batcher.last_groups} stacked program(s) for "
            f"{mts.batcher.last_lanes} lanes",
            file=sys.stderr,
        )
        return 0
    finally:
        mts.close()
        if span_tracer is not None:
            span_tracer.uninstall()
            if args.trace_out:
                span_tracer.dump(args.trace_out)
        if metrics_server is not None:
            metrics_server.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ksched-tpu-torch",
        description="flow-network cluster scheduler on PyTorch and CUDA",
    )
    # Flag surface mirrors cmd/k8sscheduler/scheduler.go:31-42.
    ap.add_argument("--max-tasks-per-pu", "-mt", type=int, default=1000)
    ap.add_argument("--pod-batch-timeout", "-pbt", type=float, default=2.0)
    ap.add_argument("--node-batch-timeout", "-nbt", type=float, default=2.0)
    ap.add_argument("--pod-chan-size", "-pcs", type=int, default=5000)
    ap.add_argument("--fake-machines", action="store_true")
    ap.add_argument("--num-machines", "-nm", type=int, default=10)
    ap.add_argument("--cores-per-machine", type=int, default=1)
    ap.add_argument("--pus-per-core", type=int, default=1)
    ap.add_argument(
        "--cost-model",
        choices=[m.name.lower() for m in CostModelType],
        default="trivial",
    )
    ap.add_argument(
        "--backend", choices=["ref", "native", "jax", "ell", "auto"],
        default="auto",
        help="MCMF backend (auto = per-solve dispatch: the dense transport "
        "kernel when the graph collapses, else the mcmf kernel, else the "
        "scan-CSR solve, solver/graph_collapse.py; native = the host C++ "
        "solver)",
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the solves run: cuda (the default; raises without a "
        "card) or cpu (every kernel's plain PyTorch version)",
    )
    ap.add_argument("--podgen", type=int, default=0, metavar="N",
                    help="generate N pods in-process (cmd/podgen equivalent)")
    ap.add_argument("--round-deadline", type=float, default=0.0, metavar="S",
                    help="per-round watchdog deadline in seconds (0 = off): "
                    "a round running past it warns and is recorded as a miss")
    ap.add_argument("--no-degrade", action="store_true",
                    help="disable the solver degradation ladder (a solver "
                    "failure then crashes the round, as the reference does)")
    ap.add_argument("--machine-timeout", type=float, default=0.0, metavar="S",
                    help="enable heartbeat-driven machine failure detection "
                    "with this timeout (0 = off); sweeps run every round")
    ap.add_argument("--one-shot", action="store_true",
                    help="exit once the pod queue is drained")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="multi-tenant mode: serve N independent synthetic "
                    "cells from this one warm process (tenancy/; "
                    "--num-machines/--max-tasks-per-pu apply per cell, "
                    "--podgen pods are split across cells); prints "
                    "per-tenant p50/p99 on exit")
    ap.add_argument("--pipeline", action="store_true",
                    help="double-buffered rounds: dispatch the solve, "
                    "post the previous round's bindings while it is in "
                    "flight, then synchronize/decode; placements are "
                    "bit-identical to the "
                    "synchronous loop")
    ap.add_argument("--device-resident", action="store_true",
                    help="keep the flow problem's arrays live on device "
                    "between rounds: after the first full upload only "
                    "packed delta records cross the host/device boundary "
                    "(graph/device_export.DeviceResidentState)")
    ap.add_argument("--audit-every", type=int, default=0, metavar="N",
                    help="device-state integrity audit cadence: every Nth "
                    "round, fingerprint the persistent device buffers "
                    "against the host journal truth and repair divergence "
                    "through the escalating ladder "
                    "(ksched_state_audits_total{result}; 0 = off; "
                    "requires --device-resident — there is no persistent "
                    "mirror to audit otherwise; runtime/integrity.py)")
    # -- observability (ksched_tpu_torch/obs) ----------------------------
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text on /metricsz (+ /healthz, "
                    "/varz) from this port (0 = ephemeral; off by default)")
    ap.add_argument("--obs-dump", metavar="PATH", default=None,
                    help="write the metrics-registry snapshot as JSON on exit")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record spans and write a Chrome/Perfetto "
                    "trace-event JSON on exit")
    ap.add_argument("--round-trace", metavar="PATH", default=None,
                    help="write the per-round RoundRecord JSONL on exit")
    ap.add_argument("--flight-dir", metavar="DIR", default=None,
                    help="enable the crash flight recorder: ring of the "
                    "last --flight-capacity rounds, auto-dumped into DIR "
                    "on deadline miss / NOOP round / crash")
    ap.add_argument("--flight-capacity", type=int, default=64)
    ap.add_argument("--devprof-capture", type=int, default=0, metavar="N",
                    help="capture a torch.profiler trace around the Nth "
                    "solve (0 = off)")
    ap.add_argument("--devprof-dir", metavar="DIR", default="./devprof")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the metrics registry entirely (null "
                    "registry; spans still time RoundTiming)")
    ap.add_argument(
        "--api-server", metavar="URL", default=None,
        help="schedule against a control plane over HTTP (the reference's "
        "-addr; see cluster/http_api.py) instead of the in-process "
        "synthetic API; --podgen then posts pods to the server",
    )
    args = ap.parse_args(argv)
    if args.one_shot and args.podgen <= 0:
        ap.error("--one-shot needs --podgen N: the pod wait blocks until a first pod arrives")
    if args.audit_every and not args.device_resident:
        ap.error(
            "--audit-every audits the persistent device mirror; without "
            "--device-resident there is nothing to audit (zero audits "
            "would run silently)"
        )
    if args.no_obs and (args.metrics_port is not None or args.obs_dump):
        ap.error(
            "--no-obs disables the metrics registry; --metrics-port/--obs-dump "
            "would serve/dump nothing (spans and --round-trace still work)"
        )

    # An operator SIGTERM must exit through main's finally so the
    # dump-on-exit artifacts (--obs-dump/--trace-out/--round-trace)
    # still land; default SIGTERM disposition would drop them.
    import signal

    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(143))

    backend = make_backend(args.backend, device=args.device)

    # -- observability setup (before any instrumented object resolves
    # its metric handles) ------------------------------------------------
    if args.no_obs:
        obs_metrics.set_enabled(False)
    metrics_server = None
    if args.metrics_port is not None:
        from .obs.exporter import MetricsServer

        metrics_server = MetricsServer(port=args.metrics_port)
        print(f"metrics: {metrics_server.url}/metricsz", file=sys.stderr)
    # the flight recorder needs a tracer too: its dumps carry each
    # round's span slice (and double as Perfetto traces)
    span_tracer = (
        SpanTracer().install() if (args.trace_out or args.flight_dir) else None
    )
    # flight-only services need records but not the whole history:
    # bound the tracer at the ring size so a weeks-long run does not
    # accumulate records nothing will ever dump. In --tenants mode the
    # multi-tenant service builds PER-TENANT tracers/recorders under
    # tenant-scoped registry views; constructing unscoped ones here
    # first would register the same family names without the tenant
    # label and the scoped views would (correctly) refuse to alias them
    tracer = None
    if args.round_trace and not args.tenants:
        tracer = RoundTracer()
    elif args.flight_dir and not args.tenants:
        tracer = RoundTracer(capacity=args.flight_capacity)
    flight = None
    if args.flight_dir and not args.tenants:
        flight = FlightRecorder(
            capacity=args.flight_capacity, dump_dir=args.flight_dir
        )
        flight.install_crash_hook()
    if args.devprof_capture > 0:
        from .obs.devprof import DeviceProfiler, set_profiler

        set_profiler(
            DeviceProfiler(
                capture_solve=args.devprof_capture, capture_dir=args.devprof_dir
            )
        )

    if args.tenants > 0:
        return _run_multi_tenant(args, span_tracer, metrics_server)

    if args.api_server:
        from .cluster.http_api import HTTPClusterAPI

        api = HTTPClusterAPI(
            args.api_server,
            pod_chan_size=args.pod_chan_size,
            registry=obs_metrics.get_registry(),
        )
    else:
        api = SyntheticClusterAPI(pod_chan_size=args.pod_chan_size)
    svc = SchedulerService(
        api,
        max_tasks_per_pu=args.max_tasks_per_pu,
        cost_model=CostModelType[args.cost_model.upper()],
        backend=backend,
        backend_name=args.backend,
        degrade=not args.no_degrade,
        round_deadline_s=args.round_deadline,
        tracer=tracer,
        flight=flight,
        span_tracer=span_tracer,
        pipeline=args.pipeline,
        device_resident=args.device_resident,
        audit_every=args.audit_every,
        device=args.device,
    )
    if args.machine_timeout > 0:
        svc.enable_heartbeats(machine_timeout_s=args.machine_timeout)
    n = svc.init_topology(
        fake_machines=args.num_machines if args.fake_machines else 0,
        node_batch_timeout_s=args.node_batch_timeout,
        cores_per_machine=args.cores_per_machine,
        pus_per_core=args.pus_per_core,
    )
    print(f"topology: {n} machines", file=sys.stderr)

    if args.podgen > 0:
        threading.Thread(target=podgen, args=(api, args.podgen), daemon=True).start()

    try:
        if args.one_shot:
            pods = api.get_pod_batch(args.pod_batch_timeout)
            # run_round, not run_once: the hardened round is also the
            # obs publication path (RoundRecord -> tracer/registry,
            # flight ring, service gauges) — one-shot must not produce
            # empty --round-trace/--flight-dir artifacts
            bound = svc.run_round(pods) if pods else 0
            svc.flush_pending_bindings()  # pipelined one-shot: post now
            lat = svc.round_latencies_s[-1] * 1e3 if svc.round_latencies_s else 0.0
            print(
                f"scheduled {bound}/{len(pods)} pods in {lat:.2f}ms "
                f"({len(api.bindings())} total bindings)",
                file=sys.stderr,
            )
            return 0
        svc.run(pod_batch_timeout_s=args.pod_batch_timeout)
        return 0
    finally:
        api.close()
        # dump-on-exit artifacts (after close so final counters settle)
        if args.obs_dump:
            from .obs.exporter import dump_registry

            dump_registry(obs_metrics.get_registry(), args.obs_dump)
            print(f"obs: registry snapshot -> {args.obs_dump}", file=sys.stderr)
        if span_tracer is not None:
            span_tracer.uninstall()
            if args.trace_out:
                span_tracer.dump(args.trace_out)
                print(f"obs: span trace -> {args.trace_out}", file=sys.stderr)
        if args.round_trace and tracer is not None:
            tracer.dump(args.round_trace)
            print(f"obs: round trace -> {args.round_trace}", file=sys.stderr)
        if metrics_server is not None:
            metrics_server.stop()


if __name__ == "__main__":
    sys.exit(main())
