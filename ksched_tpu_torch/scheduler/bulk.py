"""Bulk array-native scheduling on the host: the flat-array round.

The object/event layer (scheduler/flow_scheduler.py) mirrors the
reference's per-task API; this module is the scale path. Cluster state
lives directly in flat numpy arrays (the same layout
graph/device_export.py produces), task arrival/completion are bulk
vector operations, and a scheduling round is a handful of numpy ops +
one solve + a vectorized decode — no per-task Python work. The solve is
a backend's: the generic path hands the whole flow problem to
`backend.solve_traced` (cpu_ref, CsrSolver, MegaSolver); a backend with
`solve_layered` (LayeredTransportSolver: kernel B1 on the card) takes
the dense fast path `_round_layered`. Host arrays stay numpy, as in
ksched_tpu; only the backend's solve touches tensors.

Graph shape (the quincy-style aggregate topology, reference:
trivial_cost_modeler.go + graph_manager.go), generalized to C task
classes (C=1 for the trivial model; C=4 Sheep/Rabbit/Devil/Turtle for
CoCo / Whare-Map, task_desc.proto:25-30):

    task --(cost u, cap 1)--> unsched_agg[job]   --(cap #tasks)--> sink
    task --(cost e, cap 1)--> EC[class(task)]
    EC[c] --(cost cost[c,m], cap free_m)--> machine_m
    machine_m --(cap s, cost 0)--> PU --(cap s)--> sink

Node-id layout (dense rows, row 0 reserved):
    1 .. J                       unscheduled aggregators (one per job)
    J+1 .. J+C                   class ECs
    J+C+1 .. J+C+M               machines
    J+C+M+1 .. +M*P              PUs (P per machine)
    next                         sink
    task rows allocated/recycled after that.

Every task row is pre-wired with 1+C arcs (unsched + one per class EC)
so arc ENDPOINTS never change as rows are recycled across classes and
jobs — a solver's CSR plan is built exactly once per cluster. Only
capacities/costs flip. Per-round costs come from a vectorized cost-model
callback (`class_cost_fn`: the cluster -> cost matrix [C, M], e.g. over
its `machine_census`; or `machine_cost_fn`: the cluster -> [M]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..graph.device_export import FlowProblem
from ..obs.spans import span, unwind
from ..solver.base import FlowSolver
from ..utils import next_pow2


@dataclass
class BulkRoundResult:
    placed_tasks: np.ndarray  # task row ids newly placed this round
    placed_pus: np.ndarray  # PU row each was placed on
    preempted_tasks: np.ndarray  # task rows whose placement was revoked
    num_unscheduled: int
    timing: Dict[str, float] = field(default_factory=dict)


class BulkCluster:
    """Flat-array cluster state + vectorized scheduling rounds."""

    def __init__(
        self,
        num_machines: int,
        pus_per_machine: int,
        slots_per_pu: int,
        num_jobs: int,
        backend: FlowSolver,
        unsched_cost: int = 5,
        ec_cost: int = 2,
        machine_cost_fn: Optional[Callable[["BulkCluster"], np.ndarray]] = None,
        class_cost_fn: Optional[Callable[["BulkCluster"], np.ndarray]] = None,
        num_task_classes: int = 1,
        task_capacity: int = 2_048,
        job_unsched_cost: Optional[np.ndarray] = None,
    ) -> None:
        self.M = num_machines
        self.P = pus_per_machine
        self.S = slots_per_pu
        self.J = num_jobs
        self.C = num_task_classes
        self.backend = backend
        self.unsched_cost = unsched_cost
        self.ec_cost = ec_cost
        # Per-job unsched-arc costs (the reference's per-job unsched
        # aggregators each carry their own cost, graph_manager.go:
        # 1291-1305 + interface.go TaskToUnscheduledAggCost). None =
        # every job at the scalar unsched_cost.
        from ..solver.layered import validate_job_unsched_cost

        self.job_unsched_cost = validate_job_unsched_cost(
            job_unsched_cost, num_jobs
        )
        self.machine_cost_fn = machine_cost_fn
        self.class_cost_fn = class_cost_fn

        C = self.C
        self.unsched0 = 1
        self.ec0 = 1 + num_jobs
        self.machine0 = self.ec0 + C
        self.pu0 = self.machine0 + num_machines
        self.num_pus = num_machines * pus_per_machine
        self.sink = self.pu0 + self.num_pus
        self.task0 = self.sink + 1

        self.n_cap = next_pow2(self.task0 + task_capacity)
        self.task_cap = self.n_cap - self.task0

        # Static arc slots: EC->machine (C*M, class-major), machine->PU
        # (num_pus), PU->sink (num_pus), unsched->sink (J). Task arc
        # slots follow, 1+C per task row (-> unsched agg, -> each EC).
        self.a_ecm0 = 0
        self.a_mpu0 = self.a_ecm0 + C * num_machines
        self.a_pusink0 = self.a_mpu0 + self.num_pus
        self.a_unsink0 = self.a_pusink0 + self.num_pus
        self.a_task0 = self.a_unsink0 + num_jobs
        self.arcs_per_task = 1 + C
        self.m_cap = next_pow2(self.a_task0 + self.arcs_per_task * self.task_cap)

        self.src = np.zeros(self.m_cap, np.int32)
        self.dst = np.zeros(self.m_cap, np.int32)
        self.cap = np.zeros(self.m_cap, np.int32)
        self.cost = np.zeros(self.m_cap, np.int32)
        self.excess = np.zeros(self.n_cap, np.int64)
        self.node_type = np.full(self.n_cap, -1, np.int8)

        # Task bookkeeping (dense per task row, relative to task0).
        # Rows are partitioned into per-job pools (row r belongs to job
        # r % J) and every row's arcs are pre-wired at init, so arc
        # endpoints NEVER change: the solver's CSR plan is built once and
        # reused for the lifetime of the cluster (the structure-churn
        # killer for per-round host work).
        self.machine_enabled = np.ones(num_machines, bool)
        self.task_live = np.zeros(self.task_cap, bool)
        self.task_job = np.zeros(self.task_cap, np.int32)
        self.task_class = np.zeros(self.task_cap, np.int32)
        self.task_pu = np.full(self.task_cap, -1, np.int32)  # PU row or -1
        self.pu_running = np.zeros(self.num_pus, np.int32)
        # Per-machine running-class census [M, C] — the vectorized
        # WhareMapStats (whare_map_stats.proto:12-18).
        self.machine_census = np.zeros((num_machines, C), np.int64)
        self._job_free: List[List[int]] = [
            [r for r in range(self.task_cap - 1, -1, -1) if r % num_jobs == j]
            for j in range(num_jobs)
        ]

        self._wire_static()

    # ------------------------------------------------------------------

    def _wire_static(self) -> None:
        M, P, J, C = self.M, self.P, self.J, self.C
        machines = np.arange(M, dtype=np.int32)
        pus = np.arange(self.num_pus, dtype=np.int32)
        jobs = np.arange(J, dtype=np.int32)

        # EC[c] -> machine arcs, class-major: arc a_ecm0 + c*M + m.
        for c in range(C):
            sl = slice(self.a_ecm0 + c * M, self.a_ecm0 + (c + 1) * M)
            self.src[sl] = self.ec0 + c
            self.dst[sl] = self.machine0 + machines
            self.cap[sl] = 0  # refreshed per round from free slots
            self.cost[sl] = 0

        sl = slice(self.a_mpu0, self.a_mpu0 + self.num_pus)
        self.src[sl] = self.machine0 + (pus // P)
        self.dst[sl] = self.pu0 + pus
        self.cap[sl] = self.S

        sl = slice(self.a_pusink0, self.a_pusink0 + self.num_pus)
        self.src[sl] = self.pu0 + pus
        self.dst[sl] = self.sink
        self.cap[sl] = self.S

        sl = slice(self.a_unsink0, self.a_unsink0 + J)
        self.src[sl] = self.unsched0 + jobs
        self.dst[sl] = self.sink
        self.cap[sl] = 0  # grows with live tasks per job

        # Pre-wire every task row's arc endpoints (capacity 0 until the
        # row is occupied); row r's job is r % J. Arc layout per row:
        # [0] -> unsched agg, [1+c] -> EC c.
        rows = np.arange(self.task_cap, dtype=np.int32)
        abs_rows = self.task0 + rows
        a0 = self.a_task0 + self.arcs_per_task * rows
        self.src[a0] = abs_rows
        self.dst[a0] = self.unsched0 + (rows % J)
        for c in range(C):
            self.src[a0 + 1 + c] = abs_rows
            self.dst[a0 + 1 + c] = self.ec0 + c

        from ..graph.flowgraph import NodeType

        self.node_type[self.unsched0 : self.unsched0 + J] = int(NodeType.JOB_AGGREGATOR)
        self.node_type[self.ec0 : self.ec0 + C] = int(NodeType.EQUIV_CLASS)
        self.node_type[self.machine0 : self.machine0 + M] = int(NodeType.MACHINE)
        self.node_type[self.pu0 : self.pu0 + self.num_pus] = int(NodeType.PU)
        self.node_type[self.sink] = int(NodeType.SINK)

    # ------------------------------------------------------------------
    # Bulk task lifecycle
    # ------------------------------------------------------------------

    def add_tasks(
        self,
        count: int,
        job_ids: Optional[np.ndarray] = None,
        classes: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Admit `count` new tasks; returns their task rows (absolute ids)."""
        if job_ids is None:
            job_ids = np.zeros(count, np.int32)
        if classes is None:
            classes = np.zeros(count, np.int32)
        else:
            classes = np.asarray(classes, np.int32)
            if ((classes < 0) | (classes >= self.C)).any():
                raise ValueError(
                    f"task class out of range [0, {self.C}): {classes.min()}..{classes.max()}"
                )
        rows = np.empty(count, dtype=np.int32)
        for i, j in enumerate(job_ids):
            pool = self._job_free[int(j)]
            if not pool:
                raise RuntimeError(
                    f"task pool for job {int(j)} exhausted "
                    f"(capacity {self.task_cap // self.J} rows per job)"
                )
            rows[i] = pool.pop()
        abs_rows = self.task0 + rows
        self.task_live[rows] = True
        self.task_job[rows] = job_ids
        self.task_class[rows] = classes
        self.task_pu[rows] = -1
        self.excess[abs_rows] = 1
        from ..graph.flowgraph import NodeType

        self.node_type[abs_rows] = int(NodeType.UNSCHEDULED_TASK)
        # Arc endpoints are pre-wired (row pools are per-job); only
        # capacities and costs flip on — unsched arc plus the arc to the
        # task's OWN class EC.
        a0 = self.a_task0 + self.arcs_per_task * rows
        self.cap[a0] = 1
        if self.job_unsched_cost is not None:
            self.cost[a0] = self.job_unsched_cost[job_ids]
        else:
            self.cost[a0] = self.unsched_cost
        a_cls = a0 + 1 + classes
        self.cap[a_cls] = 1
        self.cost[a_cls] = self.ec_cost
        # unsched agg capacity grows per live task
        np.add.at(self.cap, self.a_unsink0 + job_ids, 1)
        return abs_rows

    def complete_tasks(self, abs_rows: np.ndarray) -> None:
        """Retire tasks (vectorized TaskCompleted): free their slots and
        remove their nodes/arcs."""
        rows = abs_rows - self.task0
        assert self.task_live[rows].all(), "completing a task that is not live"
        on_pu = self.task_pu[rows]
        placed = on_pu >= 0
        if placed.any():
            np.add.at(self.pu_running, on_pu[placed], -1)
            np.add.at(
                self.machine_census,
                (on_pu[placed] // self.P, self.task_class[rows[placed]]),
                -1,
            )
        # Placed tasks already gave back their unsched-agg capacity when
        # they were pinned (see round()); only unplaced ones return it now.
        if (~placed).any():
            np.add.at(self.cap, self.a_unsink0 + self.task_job[rows[~placed]], -1)
        self.task_live[rows] = False
        self.task_pu[rows] = -1
        self.excess[abs_rows] = 0
        self.node_type[abs_rows] = -1
        a0 = self.a_task0 + self.arcs_per_task * rows
        for k in range(self.arcs_per_task):
            self.cap[a0 + k] = 0
            self.cost[a0 + k] = 0
        for r in rows:
            self._job_free[int(r) % self.J].append(int(r))

    def set_machine_enabled(self, machine_index: int, enabled: bool) -> np.ndarray:
        """Elastic membership: bring a machine in/out of service
        (vectorized RegisterResource / DeregisterResource — reference:
        flowscheduler/scheduler.go:134-210). Disabling evicts every task
        placed on the machine back to the unscheduled pool; the next
        round reschedules them elsewhere. Returns the evicted task rows
        (absolute ids; empty on enable)."""
        self.machine_enabled[machine_index] = enabled
        if enabled:
            return np.empty(0, np.int32)
        pu_lo = machine_index * self.P
        pu_hi = pu_lo + self.P
        rows = np.nonzero(
            self.task_live & (self.task_pu >= pu_lo) & (self.task_pu < pu_hi)
        )[0]
        if not len(rows):
            return np.empty(0, np.int32)
        abs_rows = (self.task0 + rows).astype(np.int32)
        np.add.at(self.pu_running, self.task_pu[rows], -1)
        np.add.at(self.machine_census, (machine_index, self.task_class[rows]), -1)
        self.task_pu[rows] = -1
        # Un-pin: restore supply, re-open the task's arcs, and regrow the
        # unsched-agg escape capacity the pin consumed (inverse of the
        # pin step in round()).
        self.excess[abs_rows] = 1
        a0 = self.a_task0 + self.arcs_per_task * rows
        self.cap[a0] = 1
        self.cap[a0 + 1 + self.task_class[rows]] = 1
        np.add.at(self.cap, self.a_unsink0 + self.task_job[rows], 1)
        from ..graph.flowgraph import NodeType

        self.node_type[abs_rows] = int(NodeType.UNSCHEDULED_TASK)
        return abs_rows

    # ------------------------------------------------------------------
    # The scheduling round
    # ------------------------------------------------------------------

    def _refresh_capacities(self) -> None:
        """Per-round stats + capacity refresh (the vectorized equivalent
        of ComputeTopologyStatistics + updateEquivToResArcs)."""
        M, C = self.M, self.C
        pu_free = self.S - self.pu_running
        # Disabled machines (elastic membership / machine loss) offer no
        # capacity; their PUs are fenced at every layer of the topology.
        pu_free[~np.repeat(self.machine_enabled, self.P)] = 0
        machine_free = pu_free.reshape(M, self.P).sum(axis=1)
        # Every class EC offers each machine its full free capacity; the
        # machine node's outgoing arcs bottleneck the aggregate.
        self.cap[self.a_ecm0 : self.a_ecm0 + C * M] = np.tile(machine_free, C)
        # PU->sink and machine->PU capacity excludes running tasks
        # (capacityFromResNodeToParent with preemption off,
        # graph_manager.go:662-667).
        self.cap[self.a_mpu0 : self.a_mpu0 + self.num_pus] = pu_free
        self.cap[self.a_pusink0 : self.a_pusink0 + self.num_pus] = pu_free
        if self.class_cost_fn is not None:
            cost_cm = np.asarray(self.class_cost_fn(self), dtype=np.int32)
            assert cost_cm.shape == (C, M), f"class_cost_fn must return [C={C}, M={M}]"
            self.cost[self.a_ecm0 : self.a_ecm0 + C * M] = cost_cm.reshape(-1)
        elif self.machine_cost_fn is not None:
            cost_m = np.asarray(self.machine_cost_fn(self), dtype=np.int32)
            self.cost[self.a_ecm0 : self.a_ecm0 + C * M] = np.tile(cost_m, C)

    def _problem(self) -> FlowProblem:
        live = int(self.task_live.sum())
        placed = int((self.task_pu >= 0)[self.task_live].sum())
        self.excess[self.sink] = -(live - placed)
        return FlowProblem(
            num_nodes=self.n_cap,
            excess=self.excess,
            node_type=self.node_type,
            src=self.src,
            dst=self.dst,
            cap=self.cap,
            cost=self.cost,
            flow_offset=np.zeros(self.m_cap, np.int32),
            num_arcs=self.m_cap,
        )

    def round(self) -> BulkRoundResult:
        # Backends exposing solve_layered get the dense fast path: the
        # aggregate topology collapses to a [C, M+1] transportation
        # problem (solver/layered.py) — no CSR, no per-arc work.
        if hasattr(self.backend, "solve_layered"):
            return self._round_layered()
        timing: Dict[str, float] = {}
        with span("round", path="bulk"):
            with span("stats") as sp:
                self._refresh_capacities()
                # Placed tasks are pinned: zero their graph presence
                # (their slot stays accounted via pu_running, mirroring
                # pinTaskToNode + capacity accounting, preemption off).
            timing["stats_s"] = sp.dur_s

            with span("solve") as sp:
                problem = self._problem()
                result = self.backend.solve_traced(problem)
            timing["solve_s"] = sp.dur_s

            with span("decode") as sp:
                placed_tasks, placed_pus, num_unsched = self._decode(result.flow)
            timing["decode_s"] = sp.dur_s

            with span("apply") as sp:
                self._apply_placements(placed_tasks, placed_pus)
            timing["apply_s"] = sp.dur_s
        return BulkRoundResult(
            placed_tasks=placed_tasks,
            placed_pus=placed_pus,
            preempted_tasks=np.empty(0, np.int32),
            num_unscheduled=num_unsched,
            timing=timing,
        )

    def _apply_placements(self, placed_tasks: np.ndarray, placed_pus: np.ndarray) -> None:
        if not len(placed_tasks):
            return
        rows = placed_tasks - self.task0
        self.task_pu[rows] = placed_pus - self.pu0
        np.add.at(self.pu_running, placed_pus - self.pu0, 1)
        np.add.at(
            self.machine_census,
            ((placed_pus - self.pu0) // self.P, self.task_class[rows]),
            1,
        )
        # pin: remove the placed tasks' supply and arcs from the
        # flow problem; their slots are excluded via pu_running.
        self.excess[placed_tasks] = 0
        a0 = self.a_task0 + self.arcs_per_task * rows
        self.cap[a0] = 0
        self.cap[a0 + 1 + self.task_class[rows]] = 0
        np.add.at(self.cap, self.a_unsink0 + self.task_job[rows], -1)
        from ..graph.flowgraph import NodeType

        self.node_type[placed_tasks] = int(NodeType.SCHEDULED_TASK)

    def _round_layered(self) -> BulkRoundResult:
        """The dense fast path: aggregate counts -> [C, M+1] transport
        solve -> rank-matched decode. Produces the same objective as the
        generic path (tasks within a class are cost-interchangeable)."""
        timing: Dict[str, float] = {}
        M, C = self.M, self.C
        round_span = span("round", path="bulk_layered").__enter__()
        try:
            return self._round_layered_body(timing, M, C, round_span)
        except BaseException:
            # close whatever manual span is still open (stats/decode)
            # plus the round span, so the error is recorded and the
            # span parenting is restored for later rounds
            import sys

            unwind(round_span, *sys.exc_info())
            raise

    def _round_layered_body(self, timing, M, C, round_span):
        from ..solver.layered import LayeredProblem

        sp = span("stats").__enter__()
        self._refresh_capacities()  # keeps arrays/costs consistent for
        # checkpoints and for any later generic-path round
        pu_free = self.S - self.pu_running
        pu_free[~np.repeat(self.machine_enabled, self.P)] = 0
        machine_free = pu_free.reshape(M, self.P).sum(axis=1)
        unplaced = np.nonzero(self.task_live & (self.task_pu < 0))[0]
        cls = self.task_class[unplaced]
        cost_cm = self.cost[self.a_ecm0 : self.a_ecm0 + C * M].reshape(C, M)
        if self.job_unsched_cost is not None:
            # Per-job unsched costs make (job, class) pairs distinct
            # commodities: expand the row axis to G = J*C groups, row
            # g = j*C + c carrying class c's cost row and job j's
            # escape cost. The collapse stays exact — tasks within a
            # group are still interchangeable.
            grp = self.task_job[unplaced] * C + cls
            G = self.J * C
            supply = np.bincount(grp, minlength=G).astype(np.int32)
            lp = LayeredProblem(
                supply=supply,
                col_cap=machine_free.astype(np.int32),
                cost_cm=np.tile(cost_cm, (self.J, 1)),
                unsched_cost=self.unsched_cost,
                ec_cost=self.ec_cost,
                row_unsched_cost=np.repeat(self.job_unsched_cost, C),
            )
            row_of_task = grp
        else:
            G = C
            supply = np.bincount(cls, minlength=C).astype(np.int32)
            lp = LayeredProblem(
                supply=supply,
                col_cap=machine_free.astype(np.int32),
                cost_cm=cost_cm,
                unsched_cost=self.unsched_cost,
                ec_cost=self.ec_cost,
            )
            row_of_task = cls
        timing["stats_s"] = sp.finish()

        with span("solve", path="layered") as sp:
            res = self.backend.solve_layered(lp)
            # solver-interior telemetry (obs/soltel.py): the layered
            # backend is dispatched here, not through solve_traced, so
            # this is its publication seam
            tel = getattr(self.backend, "last_telemetry", None)
            if tel is not None:
                from ..obs import soltel

                soltel.publish(tel, sp)
        timing["solve_s"] = sp.dur_s

        sp = span("decode").__enter__()
        y = res.y  # int64[G, M]
        placed_per_row = y.sum(axis=1)
        # Stage 1 — pick which tasks place (any within-row choice is
        # cost-identical) and pair them rank-for-rank with the machine
        # grants, machine-major per row. One stable argsort groups the
        # unplaced tasks row-major (row order preserved within a row),
        # so each row's first placed_per_row[g] entries pair with that
        # row's grants — O(n log n), no per-group rescans.
        order = np.argsort(row_of_task, kind="stable")
        counts = np.bincount(row_of_task, minlength=G)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        sorted_grp = row_of_task[order]
        rank_in_row = np.arange(len(order), dtype=np.int64) - starts[sorted_grp]
        take = rank_in_row < placed_per_row[sorted_grp]
        placed_rows = unplaced[order[take]]
        # grants expanded row-major then machine-major — the same order
        # as placed_rows after the argsort
        machine_of_task = np.repeat(
            np.tile(np.arange(M, dtype=np.int64), G), y.reshape(-1)
        )
        # Stage 2 — split each machine's grant across its PUs in slot
        # order, then pair with tasks sorted (stably) by machine.
        t_m = y.sum(axis=0)
        pf2 = pu_free.reshape(M, self.P)
        excl = np.cumsum(pf2, axis=1) - pf2
        grants = np.clip(t_m[:, None] - excl, 0, pf2)
        assert (grants.sum(axis=1) == t_m).all(), "PU split infeasible"
        pu_grants = np.repeat(np.arange(self.num_pus, dtype=np.int64), grants.reshape(-1))
        order = np.argsort(machine_of_task, kind="stable")
        placed_pus = np.empty(len(placed_rows), dtype=np.int32)
        placed_pus[order] = (self.pu0 + pu_grants).astype(np.int32)
        placed_tasks = (self.task0 + placed_rows).astype(np.int32)
        timing["decode_s"] = sp.finish()

        with span("apply") as sp:
            self._apply_placements(placed_tasks, placed_pus)
        timing["apply_s"] = sp.dur_s
        round_span.finish()
        return BulkRoundResult(
            placed_tasks=placed_tasks,
            placed_pus=placed_pus,
            preempted_tasks=np.empty(0, np.int32),
            num_unscheduled=res.num_unsched,
            timing=timing,
        )

    def _decode(self, flow: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """Vectorized flow decomposition for the class-EC topology: each
        EC is a single hub, so any bijection between its inflow units
        (tasks of that class) and its outflow units (EC->machine flows)
        is a valid decomposition; likewise rank-matching machine inflow
        units to PU grants within each machine."""
        M, C = self.M, self.C
        rows = np.nonzero(self.task_live & (self.task_pu < 0))[0]
        a_cls = self.a_task0 + self.arcs_per_task * rows + 1 + self.task_class[rows]
        placed_mask = flow[a_cls] > 0
        placed_rows = rows[placed_mask]
        cls_of_placed = self.task_class[placed_rows]

        ecm = flow[self.a_ecm0 : self.a_ecm0 + C * M].astype(np.int64).reshape(C, M)
        mpu = flow[self.a_mpu0 : self.a_mpu0 + self.num_pus].astype(np.int64)
        assert ecm.sum() == len(placed_rows), (
            f"EC outflow {ecm.sum()} != placed tasks {len(placed_rows)}"
        )
        assert mpu.sum() == ecm.sum(), "machine->PU flow mismatch"

        # Stage 1 — task -> machine, per class: tasks of class c (row
        # order) pair rank-for-rank with repeat(machines, ecm[c]) (flow
        # conservation at EC c makes the counts equal).
        machine_of_task = np.empty(len(placed_rows), dtype=np.int64)
        for c in range(C):
            sel = cls_of_placed == c
            machine_of_task[sel] = np.repeat(np.arange(M, dtype=np.int64), ecm[c])
        # Stage 2 — machine -> PU: total machine inflow equals its PU
        # outflow; expand PU grants machine-major and pair them with the
        # placed tasks sorted (stably) by machine. Any within-machine
        # bijection is a valid decomposition.
        pu_grants = np.repeat(np.arange(self.num_pus, dtype=np.int64), mpu)
        order = np.argsort(machine_of_task, kind="stable")
        pus_for_tasks = np.empty(len(placed_rows), dtype=np.int32)
        pus_for_tasks[order] = (self.pu0 + pu_grants).astype(np.int32)

        num_unsched = int(self.task_live.sum() - (self.task_pu >= 0).sum() - len(placed_rows))
        return (self.task0 + placed_rows).astype(np.int32), pus_for_tasks, num_unsched

    # ------------------------------------------------------------------

    @property
    def num_live_tasks(self) -> int:
        return int(self.task_live.sum())

    @property
    def num_placed_tasks(self) -> int:
        return int((self.task_pu >= 0).sum())
