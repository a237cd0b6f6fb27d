"""The placement solver driver: graph manager → backend → task mapping.

Reference: scheduling/flow/placement/solver.go:60-123. Round 1 exports
the full graph; round N first refreshes task→unsched costs
(UpdateAllCostsToUnscheduledAggs) and then ships only the journaled
changes. In the reference the export is DIMACS text to a daemon
subprocess; here it is a scatter into the flat host arrays
(DeviceGraphState), and the backend is called in-process.
"""

from __future__ import annotations

from collections import Counter

from ..graph.device_export import DeviceGraphState, DeviceResidentState
from ..graph.graph_manager import GraphManager, TaskMapping
from ..obs.devprof import get_profiler
from ..obs.spans import span
from .base import FlowSolver
from .decode import flow_to_mapping


class PlacementSolver:
    """``device_resident=True`` keeps the folded problem arrays live on
    the card between rounds (graph/device_export.DeviceResidentState, on
    the backend's device): after the first full upload each round ships
    only the packed delta records, and device-aware backends consume the
    handle without uploading anything. Host consumers (decode, the
    objective) are unaffected: the handle still carries the host
    arrays."""

    def __init__(
        self,
        gm: GraphManager,
        backend: FlowSolver,
        incremental: bool = True,
        device_resident: bool = False,
    ) -> None:
        self.gm = gm
        self.backend = backend
        self.incremental = incremental
        self.state = DeviceGraphState()
        self.resident = (
            DeviceResidentState(self.state, getattr(backend, "device", "cuda"))
            if device_resident else None
        )
        self._started = False
        self.last_result = None
        # ---- device-state integrity (runtime/integrity.py) -----------
        #: audit cadence in exports (0 = off); the service sets it from
        #: --audit-every. On due rounds the post-refresh mirror is
        #: fingerprinted against the host journal truth and divergence
        #: is repaired through the escalating ladder before the solve.
        self.audit_every = 0
        self.auditor = None
        self._export_count = 0
        #: array names that diverged on the LAST audited export (the
        #: service's flight-dump trigger), None when clean
        self.last_divergence = None
        #: cumulative integrity accounting for this solver's lifetime
        #: (divergences, repair_<rung>): soaks sum it across restores
        self.integrity_counts = Counter()

    def solve_async(self):
        """Phase 1 of a pipelined round: export the journal, snapshot
        the problem, and run the backend solve. The problem arrays are
        a snapshot, so the caller may keep journaling next-round graph
        mutations before complete() decodes. Backends without
        solve_async run synchronously here (the token then carries the
        result)."""
        gm = self.gm
        full = not self._started or not self.incremental
        changes = None
        with span("graph_export", kind="full_build" if full else "delta"):
            if full:
                self._started = True
                self.state.full_build(gm.cm.graph)
                gm.cm.reset_changes()
                self.backend.reset()
            else:
                gm.update_all_costs_to_unscheduled_aggs()
                changes = gm.cm.get_optimized_graph_changes()
                self.state.apply_changes(changes)
                gm.cm.reset_changes()
            # Sink excess is maintained outside the journal (reference:
            # graph_manager.go:636-640); sync it before each solve.
            self.state.set_excess(gm.sink_node.id, gm.sink_node.excess)
            if self.resident is not None:
                # pack + scatter this round's delta into the persistent
                # tensors (delta_pack / delta_upload child spans)
                problem = self.resident.refresh()
                problem = self._integrity_gate(problem)
            else:
                problem = self.state.problem()
        # Byte accounting: in device-resident mode the exact bytes the
        # mirror copied to the card (packed records, or the rebuild
        # upload); otherwise estimated from the journal just applied.
        if self.resident is not None:
            get_profiler().note_export(
                problem,
                full=self.resident.last_upload_kind == "full_build",
                exact_bytes=self.resident.last_upload_bytes,
            )
        else:
            get_profiler().note_export(problem, full=full, changes=changes)
        # Task nodes captured NOW: the decode must map the snapshot's
        # tasks, not tasks added while the solve is in flight.
        task_node_ids = [node.id for node in gm.task_to_node.values()]
        get_profiler().solve_starting()
        try:
            if hasattr(self.backend, "solve_async"):
                pending = self.backend.solve_async(problem)
                return (problem, task_node_ids, pending, True)
            return (problem, task_node_ids, self.backend.solve_traced(problem), False)
        except BaseException:
            get_profiler().solve_failed()  # stop an Nth-solve capture
            raise

    def _integrity_gate(self, problem):
        """The post-refresh integrity seam: apply any injected device
        corruption (the chaos seam — the injector rides the ladder
        backend, so corruption is drawn and contained like solver
        faults), then on audit-due rounds fingerprint the mirror against
        the host truth and run the divergence response ladder:
        re-scatter the diverged rows -> full re-upload -> full_build
        (here) -> the degradation ladder's NOOP backstop. Repairs
        restore the exact host values, so a repaired round's placements
        are bit-identical to a clean-state solve."""
        inj = getattr(self.backend, "injector", None)
        if inj is not None and hasattr(inj, "device_corruption"):
            available = {"excess", "src", "dst", "cap", "cost"}
            if self.resident.d_p_sign is not None:
                available |= {"p_arc", "p_sign", "p_src", "p_dst"}
            spec = inj.device_corruption(
                self.state.n_cap, self.state.m_cap, available=available)
            if spec is not None:
                from ..runtime.integrity import apply_device_corruption

                apply_device_corruption(self.resident, spec)
                self.resident.rebind(problem)
        self.last_divergence = None
        self._export_count += 1
        if not self.audit_every or (self._export_count - 1) % self.audit_every:
            return problem
        from ..runtime.checkpoint import find_jax_solver
        from ..runtime.integrity import IntegrityError, StateAuditor

        if self.auditor is None or self.auditor.resident is not self.resident:
            self.auditor = StateAuditor(self.resident)
        # the solver's carried warm flow is solver-owned device state:
        # fingerprint it against the solver's host copy alongside the
        # mirror (a diverged warm carry escalates straight to
        # full_build below, whose backend.reset() drops it)
        csr = find_jax_solver(self.backend)
        warm_flow = warm_expected = None
        if csr is not None and csr._prev_dev is not None and csr._prev is not None:
            warm_flow, warm_expected = csr._prev_dev, csr._prev
        with span("state_audit"):
            diverged = self.auditor.audit(warm_flow, warm_expected)
        if not diverged:
            return problem
        self.last_divergence = list(diverged)
        self.integrity_counts["divergences"] += 1
        try:
            with span("state_repair", arrays=len(diverged)):
                rung = self.auditor.repair(diverged)
            self.integrity_counts[f"repair_{rung}"] += 1
            self.resident.rebind(problem)
            return problem
        except IntegrityError:
            pass
        # ladder exhausted on the mirror: rebuild the device state from
        # the host graph wholesale — the last repair rung before the
        # degradation ladder's NOOP round. full_build reassigns the
        # slot table, so warm solver state is dropped with it.
        self.integrity_counts["repair_full_build"] += 1
        with span("state_repair", kind="full_build"):
            gm = self.gm
            self.state.full_build(gm.cm.graph)
            gm.cm.reset_changes()
            self.backend.reset()
            self.state.set_excess(gm.sink_node.id, gm.sink_node.excess)
            problem = self.resident.refresh()
        self.auditor._m_repairs.labels(rung="full_build").inc()
        return problem

    def complete(self, token) -> TaskMapping:
        """Phase 2: synchronize the solve and decode the task mapping."""
        problem, task_node_ids, pending, is_async = token
        if is_async:
            try:
                with span("backend_solve", backend=type(self.backend).__name__) as sp:
                    result = self.backend.complete(pending)
                    # async dispatches bypass solve_traced; publish the
                    # solver-interior telemetry here instead
                    tel = getattr(self.backend, "last_telemetry", None)
                    if tel is not None:
                        from ..obs import soltel

                        soltel.publish(tel, sp)
            except BaseException:
                get_profiler().solve_failed()  # stop an Nth-solve capture
                raise
        else:
            result = pending
        self.last_result = result
        get_profiler().note_solve(self.backend, problem, result)
        gm = self.gm
        with span("decode", tasks=len(task_node_ids)):
            return flow_to_mapping(
                problem,
                result.total_flow(problem),
                gm.leaf_node_ids,
                gm.sink_node.id,
                task_node_ids,
            )

    def solve(self) -> TaskMapping:
        return self.complete(self.solve_async())
