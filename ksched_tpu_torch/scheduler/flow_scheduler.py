"""L6: the flow scheduler service — the event-driven round loop.

Reference: scheduling/flow/flowscheduler/{interface.go,scheduler.go}.
Same event surface: AddJob, Register/DeregisterResource, ScheduleAllJobs/
ScheduleJobs, HandleTask{Completion,Placement,Eviction,Migration,Failure},
HandleJobCompletion, KillRunningTask, GetTaskBindings. A scheduling round
is: compute topology statistics → add/update job nodes → solve → deltas
(PREEMPT first, then PLACE/MIGRATE) → apply → refresh topology.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..costmodels.base import CostModeler
from ..costmodels.trivial import TrivialCostModel
from ..data import (
    DeltaType,
    JobDescriptor,
    JobState,
    ResourceDescriptor,
    ResourceState,
    ResourceTopologyNodeDescriptor,
    ResourceType,
    SchedulingDelta,
    TaskDescriptor,
    TaskState,
)
from ..graph.changes import ChangeStats
from ..graph.graph_manager import GraphManager, TaskMapping
from ..obs.spans import span, start_span
from ..solver.base import FlowSolver
from ..solver.placement import PlacementSolver
from ..solver.select import make_backend
from ..utils import JobMap, ResourceMap, TaskMap, job_id_from_string, resource_id_from_string


@dataclass
class RoundTiming:
    """Per-phase wall-clock breakdown of one scheduling round (the
    reference only times the whole round ad hoc in its CLI,
    cmd/k8sscheduler/scheduler.go:146-150; we make phases first-class).

    Every field is the duration of an obs span (`round` → `stats`,
    `graph_update`, `solve`, `deltas`, `apply`), so the RoundRecord
    JSONL (runtime/trace.py) and a captured Perfetto trace are two
    views of the same measurement and can never disagree."""

    stats_s: float = 0.0
    graph_update_s: float = 0.0
    solve_s: float = 0.0
    deltas_s: float = 0.0
    apply_s: float = 0.0
    total_s: float = 0.0


class FlowScheduler:
    def __init__(
        self,
        resource_map: ResourceMap,
        job_map: JobMap,
        task_map: TaskMap,
        root: ResourceTopologyNodeDescriptor,
        max_tasks_per_pu: int = 1,
        cost_model: Optional[CostModeler] = None,
        cost_model_factory=None,
        backend: Optional[FlowSolver] = None,
        preemption: bool = False,
        device_resident: bool = False,
    ) -> None:
        self.resource_map = resource_map
        self.job_map = job_map
        self.task_map = task_map
        self.resource_topology = root

        leaf_resource_ids: Set[int] = set()
        self.dimacs_stats = ChangeStats()
        if cost_model is None and cost_model_factory is not None:
            # Every model shares the Trivial constructor signature; the
            # factory form exists because leaf_resource_ids is owned here.
            cost_model = cost_model_factory(
                resource_map, task_map, leaf_resource_ids, max_tasks_per_pu
            )
        self.cost_model = cost_model or TrivialCostModel(
            resource_map, task_map, leaf_resource_ids, max_tasks_per_pu
        )
        self.gm = GraphManager(
            self.cost_model,
            leaf_resource_ids,
            self.dimacs_stats,
            max_tasks_per_pu,
            preemption=preemption,
        )
        self.gm.add_resource_topology(root)
        # default backend: the dense-collapse dispatch on the card
        # (make_backend("auto") raises when no CUDA device is present)
        self.solver = PlacementSolver(
            self.gm,
            backend if backend is not None else make_backend("auto"),
            device_resident=device_resident,
        )

        self.resource_roots: Set[int] = set()  # ids of registered topology roots
        self._root_rtnds: Dict[int, ResourceTopologyNodeDescriptor] = {}
        # The coordinator root registered above IS a topology root: the
        # per-iteration UpdateResourceTopology pass (reference
        # flowscheduler/scheduler.go:371-375) walks the roots to refresh
        # num_slots_below/num_running_tasks_below — without this entry
        # the refresh walks nothing and running-task stats never update.
        root_rid = resource_id_from_string(root.resource_desc.uuid)
        self.resource_roots.add(root_rid)
        self._root_rtnds[root_rid] = root
        self.task_bindings: Dict[int, int] = {}
        self.resource_bindings: Dict[int, Set[int]] = {}
        self.jobs_to_schedule: Dict[int, JobDescriptor] = {}
        self.runnable_tasks: Dict[int, Set[int]] = {}
        self.last_timing = RoundTiming()
        #: pipelined-round state: (solver token, timing, round span)
        #: while a dispatched solve is in flight, else None
        self._round_in_flight = None

    # ------------------------------------------------------------------
    # Event API
    # ------------------------------------------------------------------

    def get_task_bindings(self) -> Dict[int, int]:
        return self.task_bindings

    def add_job(self, jd: JobDescriptor) -> None:
        self.jobs_to_schedule[job_id_from_string(jd.uuid)] = jd

    def handle_job_completion(self, job_id: int) -> None:
        """Reference: flowscheduler/scheduler.go:93-104."""
        self._check_not_in_flight("handle_job_completion")
        self.gm.job_completed(job_id)
        jd = self.job_map.find(job_id)
        assert jd is not None, f"job {job_id} must exist"
        self.jobs_to_schedule.pop(job_id, None)
        self.runnable_tasks.pop(job_id, None)
        jd.state = JobState.COMPLETED

    def handle_task_completion(self, td: TaskDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:106-132."""
        self._check_not_in_flight("handle_task_completion")
        rid = self.task_bindings.get(td.uid)
        assert rid is not None, f"task {td.uid} must be bound to a resource"
        if not self._unbind_task_from_resource(td, rid):
            raise RuntimeError(f"could not unbind task {td.uid} from resource {rid}")
        td.state = TaskState.COMPLETED
        self.cost_model.record_task_completion(td)
        self.gm.task_completed(td.uid)

    def register_resource(self, rtnd: ResourceTopologyNodeDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:134-160."""
        stack = [rtnd]
        while stack:
            cur = stack.pop()
            rd = cur.resource_desc
            if rd.type == ResourceType.PU:
                rd.schedulable = True
                if rd.state == ResourceState.UNKNOWN:
                    rd.state = ResourceState.IDLE
            stack.extend(cur.children)
        self.gm.add_resource_topology(rtnd)
        rid = resource_id_from_string(rtnd.resource_desc.uuid)
        if rtnd.parent_id == "":
            self.resource_roots.add(rid)
            self._root_rtnds[rid] = rtnd

    def deregister_resource(self, rtnd: ResourceTopologyNodeDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:162-210."""
        self._check_not_in_flight("deregister_resource")
        self._dfs_evict_tasks(rtnd)
        self.gm.remove_resource_topology(rtnd.resource_desc)
        rid = resource_id_from_string(rtnd.resource_desc.uuid)
        self.resource_roots.discard(rid)
        self._root_rtnds.pop(rid, None)
        self._dfs_clean_up_resource(rtnd)
        if rtnd.parent_id:
            parent_rs = self.resource_map.find(resource_id_from_string(rtnd.parent_id))
            assert parent_rs is not None, f"parent of {rtnd.resource_desc.uuid} must exist"
            parent_node = parent_rs.topology_node
            parent_node.children = [
                c for c in parent_node.children if c.resource_desc.uuid != rtnd.resource_desc.uuid
            ]

    def handle_task_placement(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:212-229.

        Fenced like the other placement-mutating events: an external
        placement while a pipelined round is in flight would bind a
        task the dispatched snapshot still maps as schedulable. The
        internal caller (delta application) runs after the latch
        clears."""
        self._check_not_in_flight("handle_task_placement")
        self._handle_task_placement(td, rd)

    def _handle_task_placement(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        td.scheduled_to_resource = rd.uuid
        self.gm.task_scheduled(td.uid, resource_id_from_string(rd.uuid))
        self._bind_task_to_resource(td, rd)
        runnables = self.runnable_tasks.get(job_id_from_string(td.job_id))
        if runnables is not None:
            runnables.discard(td.uid)
        self._execute_task(td, rd)

    def handle_task_eviction(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:231-246.

        Externally driven evictions are fenced like the other
        placement-mutating events: an eviction during an in-flight
        pipelined round would unbind a task the dispatched snapshot
        still maps, letting _finish_round decode a stale PLACE for it.
        Internal callers (delta application, deregister's evict-DFS)
        run after the latch clears and use _evict_task directly."""
        self._check_not_in_flight("handle_task_eviction")
        self._evict_task(td, rd)

    def _evict_task(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        rid = resource_id_from_string(rd.uuid)
        self.gm.task_evicted(td.uid, rid)
        if not self._unbind_task_from_resource(td, rid):
            raise RuntimeError(f"could not unbind task {td.uid} from resource {rid}")
        td.state = TaskState.RUNNABLE
        self._insert_task_into_runnables(job_id_from_string(td.job_id), td.uid)

    def handle_task_migration(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:248-270. Fenced while
        a pipelined round is in flight (see handle_task_placement);
        delta application uses _handle_task_migration after the latch
        clears."""
        self._check_not_in_flight("handle_task_migration")
        self._handle_task_migration(td, rd)

    def _handle_task_migration(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        old_rid = self.task_bindings[td.uid]
        new_rid = resource_id_from_string(rd.uuid)
        # scheduledToResource must be up to date before TaskMigrated
        # (reference hack note at :254-259).
        td.scheduled_to_resource = rd.uuid
        self.gm.task_migrated(td.uid, old_rid, new_rid)
        rd.state = ResourceState.BUSY
        td.state = TaskState.RUNNING
        if not self._unbind_task_from_resource(td, old_rid):
            raise RuntimeError(f"binding {td.uid}->{old_rid} must exist")
        self._bind_task_to_resource(td, rd)

    def handle_task_failure(self, td: TaskDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:272-287."""
        self._check_not_in_flight("handle_task_failure")
        self.gm.task_failed(td.uid)
        rid = self.task_bindings.get(td.uid)
        assert rid is not None, f"failed task {td.uid} should have been bound"
        self._unbind_task_from_resource(td, rid)
        td.state = TaskState.FAILED

    def kill_running_task(self, task_id: int) -> None:
        """Reference: flowscheduler/scheduler.go:289-306."""
        self._check_not_in_flight("kill_running_task")
        self.gm.task_killed(task_id)
        td = self.task_map.find(task_id)
        assert td is not None, f"unknown task {task_id}"
        if td.state != TaskState.RUNNING or task_id not in self.task_bindings:
            raise RuntimeError(f"task {task_id} not bound or not running")
        td.state = TaskState.ABORTED

    # ------------------------------------------------------------------
    # The scheduling round
    # ------------------------------------------------------------------

    def schedule_all_jobs(self):
        """Reference: flowscheduler/scheduler.go:309-318."""
        jds = [
            jd for jd in self.jobs_to_schedule.values()
            if len(self._compute_runnable_tasks_for_job(jd)) > 0
        ]
        return self.schedule_jobs(jds)

    # ------------------------------------------------------------------
    # Pipelined rounds: dispatch the solve, overlap host work, finish
    # ------------------------------------------------------------------

    def schedule_all_jobs_async(self):
        """Phase 1 of a pipelined round: stats refresh + graph update +
        solve DISPATCH; returns before the solve completes. While the
        round is in flight the caller may keep ADDING jobs and tasks —
        their graph mutations journal for the next round, mirroring the
        reference's pod batching (k8sclient/client.go:153-193) which
        accumulates arrivals while the solver subprocess crunches.
        Events that mutate existing placements (completion, failure,
        kill, deregister) raise until finish_scheduling() applies the
        in-flight round's deltas. Returns None when no job has runnable
        tasks (nothing dispatched; finish_scheduling must not be
        called)."""
        if self._round_in_flight is not None:
            raise RuntimeError("a scheduling round is already in flight")
        jds = [
            jd for jd in self.jobs_to_schedule.values()
            if len(self._compute_runnable_tasks_for_job(jd)) > 0
        ]
        if not jds:
            return None
        timing, round_span = self._begin_round(jds)
        try:
            with span("solve_dispatch") as sp:
                token = self.solver.solve_async()
            timing.solve_s = sp.dur_s  # dispatch only
        except BaseException:
            round_span.__exit__(*sys.exc_info())
            raise
        self._round_in_flight = (token, timing, round_span)
        return token

    def finish_scheduling(self):
        """Phase 2: synchronize the solve, apply deltas, close the
        round. Returns (num_scheduled, deltas) like schedule_jobs."""
        if self._round_in_flight is None:
            raise RuntimeError("no scheduling round in flight")
        token, timing, round_span = self._round_in_flight
        try:
            try:
                with span("solve_sync") as sp:
                    task_mappings = self.solver.complete(token)
            finally:
                # the latch must clear even when the solver raises
                # (overflow / non-convergence), or every later event
                # handler would refuse with "in flight" forever — and it
                # must be off before delta application anyway, for the
                # internal placement/eviction handlers
                self._round_in_flight = None
            timing.solve_s += sp.dur_s  # + synchronize
            return self._finish_round(task_mappings, timing, round_span)
        except BaseException:
            round_span.__exit__(*sys.exc_info())
            raise

    def _begin_round(self, jds):
        """The pre-solve half of a round, shared by the synchronous
        and pipelined paths: mutation-counter reset, topology stats
        refresh, and the job/task graph update. Opens the `round` span
        (closed by _finish_round — or here, on an exception)."""
        timing = RoundTiming()
        round_span = start_span("round", jobs=len(jds))
        try:
            # Reset the mutation counters at round START (the reference
            # resets after the round, flowscheduler/scheduler.go:332,
            # which zeroes them before any post-round reader — e.g. the
            # round tracer — can observe the round's mutation counts).
            self.dimacs_stats.reset()
            with span("stats") as sp:
                self.gm.compute_topology_statistics(self.gm.sink_node)
            timing.stats_s = sp.dur_s
            with span("graph_update") as sp:
                self.gm.add_or_update_job_nodes(jds)
            timing.graph_update_s = sp.dur_s
        except BaseException:
            round_span.__exit__(*sys.exc_info())
            raise
        return timing, round_span

    def _finish_round(self, task_mappings, timing, round_span):
        """The post-solve half of a round, shared by the synchronous
        and pipelined paths (so delta decoding / feedback can never
        drift between them): preemption deltas + binding diffs, delta
        application, per-root topology refresh, EC purge, and the
        unscheduled-feedback hook. Closes the `round` span; its
        duration IS timing.total_s."""
        try:
            with span("deltas") as sp:
                deltas = self.gm.scheduling_deltas_for_preempted_tasks(
                    task_mappings, self.resource_map
                )
                for task_node_id, res_node_id in task_mappings.items():
                    delta = self.gm.node_binding_to_scheduling_delta(
                        task_node_id, res_node_id, self.task_bindings
                    )
                    if delta is not None:
                        deltas.append(delta)
            timing.deltas_s = sp.dur_s

            with span("apply") as sp:
                num_scheduled = self._apply_scheduling_deltas(deltas)
                for rid in self.resource_roots:
                    self.gm.update_resource_topology(self._root_rtnds[rid])
            timing.apply_s = sp.dur_s
            self.gm.purge_unconnected_equiv_class_nodes()
            # Policy feedback: which runnable tasks stayed unscheduled
            # (drives e.g. Quincy's wait-cost starvation bound).
            unscheduled = [
                t
                for tasks in self.runnable_tasks.values()
                for t in tasks
                if t not in self.task_bindings
            ]
            self.cost_model.note_round(unscheduled)
        except BaseException:
            round_span.__exit__(*sys.exc_info())
            raise
        round_span.set("num_scheduled", num_scheduled)
        timing.total_s = round_span.finish()
        self.last_timing = timing
        return num_scheduled, deltas

    def _check_not_in_flight(self, what: str) -> None:
        if self._round_in_flight is not None:
            raise RuntimeError(
                f"{what} while a pipelined scheduling round is in flight; "
                "call finish_scheduling() first (only job/task ADDITIONS "
                "may overlap an in-flight round)"
            )

    def schedule_jobs(self, jds: List[JobDescriptor]):
        """Reference: flowscheduler/scheduler.go:321-338."""
        self._check_not_in_flight("schedule_jobs")
        if not jds:
            timing = RoundTiming()
            self.last_timing = timing
            return 0, []
        timing, round_span = self._begin_round(jds)
        try:
            # Reference round body: flowscheduler/scheduler.go:340-375.
            with span("solve") as sp:
                task_mappings = self.solver.solve()
            timing.solve_s = sp.dur_s
            return self._finish_round(task_mappings, timing, round_span)
        except BaseException:
            round_span.__exit__(*sys.exc_info())
            raise

    def _apply_scheduling_deltas(self, deltas: List[SchedulingDelta]) -> int:
        """Reference: flowscheduler/scheduler.go:377-412."""
        num_scheduled = 0
        for d in deltas:
            td = self.task_map.find(d.task_id)
            assert td is not None, f"no descriptor for task {d.task_id}"
            rs = self.resource_map.find(resource_id_from_string(d.resource_id))
            assert rs is not None, f"no status for resource {d.resource_id}"
            if d.type == DeltaType.PLACE:
                jd = self.job_map.find(job_id_from_string(td.job_id))
                if jd.state != JobState.RUNNING:
                    jd.state = JobState.RUNNING
                self._handle_task_placement(td, rs.descriptor)
                num_scheduled += 1
            elif d.type == DeltaType.PREEMPT:
                self._evict_task(td, rs.descriptor)
            elif d.type == DeltaType.MIGRATE:
                self._handle_task_migration(td, rs.descriptor)
            elif d.type == DeltaType.NOOP:
                pass
            else:
                raise ValueError(f"unknown delta type {d.type}")
        return num_scheduled

    # ------------------------------------------------------------------
    # Bindings bookkeeping
    # ------------------------------------------------------------------

    def _bind_task_to_resource(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        """Reference: flowscheduler/scheduler.go:421-437."""
        task_id = td.uid
        rid = resource_id_from_string(rd.uuid)
        rd.state = ResourceState.BUSY
        rd.current_running_tasks.append(task_id)
        assert task_id not in self.task_bindings, f"task {task_id} already bound"
        self.task_bindings[task_id] = rid
        self.resource_bindings.setdefault(rid, set()).add(task_id)

    def _unbind_task_from_resource(self, td: TaskDescriptor, rid: int) -> bool:
        """Reference: flowscheduler/scheduler.go:443-464."""
        task_id = td.uid
        rs = self.resource_map.find(rid)
        rd = rs.descriptor
        if len(rd.current_running_tasks) == 0:
            rd.state = ResourceState.IDLE
        if task_id not in self.task_bindings:
            return False
        task_set = self.resource_bindings.get(rid, set())
        if task_id not in task_set:
            return False
        del self.task_bindings[task_id]
        task_set.discard(task_id)
        return True

    def _execute_task(self, td: TaskDescriptor, rd: ResourceDescriptor) -> None:
        """No real executor, as in the reference (scheduler.go:469-474)."""
        td.state = TaskState.RUNNING
        td.scheduled_to_resource = rd.uuid

    def _insert_task_into_runnables(self, job_id: int, task_id: int) -> None:
        self.runnable_tasks.setdefault(job_id, set()).add(task_id)

    def _compute_runnable_tasks_for_job(self, jd: JobDescriptor) -> Set[int]:
        """Dependency-free lazy graph reduction (reference:
        flowscheduler/scheduler.go:493-529)."""
        job_id = job_id_from_string(jd.uuid)
        root = jd.root_task
        queue: List[TaskDescriptor] = []
        if root.state in (
            TaskState.CREATED,
            TaskState.RUNNING,
            TaskState.RUNNABLE,
            TaskState.COMPLETED,
        ):
            queue.append(root)
        while queue:
            cur = queue.pop()
            queue.extend(cur.spawned)
            if cur.state in (TaskState.CREATED, TaskState.BLOCKING):
                cur.state = TaskState.RUNNABLE
                self._insert_task_into_runnables(job_id_from_string(cur.job_id), cur.uid)
        return self.runnable_tasks.setdefault(job_id, set())

    # ------------------------------------------------------------------
    # Resource removal helpers
    # ------------------------------------------------------------------

    def _dfs_evict_tasks(self, rtnd: ResourceTopologyNodeDescriptor) -> None:
        for child in rtnd.children:
            self._dfs_evict_tasks(child)
        self._evict_tasks_from_resource(rtnd)

    def _evict_tasks_from_resource(self, rtnd: ResourceTopologyNodeDescriptor) -> None:
        rd = rtnd.resource_desc
        rid = resource_id_from_string(rd.uuid)
        for task_id in list(self.resource_bindings.get(rid, ())):
            td = self.task_map.find(task_id)
            assert td is not None, f"descriptor for task {task_id} must exist"
            self._evict_task(td, rd)

    def _dfs_clean_up_resource(self, rtnd: ResourceTopologyNodeDescriptor) -> None:
        for child in rtnd.children:
            self._dfs_clean_up_resource(child)
        rid = resource_id_from_string(rtnd.resource_desc.uuid)
        self.resource_bindings.pop(rid, None)
        self.resource_map.remove(rid)
