"""The placement solver driver: graph manager → backend → task mapping.

Reference: scheduling/flow/placement/solver.go:60-123. Round 1 exports
the full graph; round N first refreshes task→unsched costs
(UpdateAllCostsToUnscheduledAggs) and then ships only the journaled
changes. In the reference the export is DIMACS text to a daemon
subprocess; here it is a scatter into the flat host arrays
(DeviceGraphState), and the backend is called in-process.
"""

from __future__ import annotations

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
                # tensors (delta_pack / delta_upload child spans); the
                # JAX package's integrity gate runs here (ROADMAP item 9)
                problem = self.resident.refresh()
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
