"""L5': the solver-dispatch boundary.

Reference: scheduling/flow/placement/solver.go:36-38 — a single-method
``Solve() -> TaskMapping`` seam behind which the MCMF backend lives. The
wire format is flat arrays (graph/device_export.FlowProblem) instead of
DIMACS text, and the backends plug in behind it:

- ReferenceSolver (solver/cpu_ref.py): exact successive-shortest-path
  oracle, pure Python — the test oracle;
- CsrSolver (solver/csr_solver.py): the scan-CSR cost-scaling
  push-relabel over any graph, in plain PyTorch;
- MegaSolver (solver/mega_solver.py): the same solve as one CUDA kernel
  launch on the card;
- AutoSolver (solver/graph_collapse.py): collapses the graph to a dense
  transport problem solved by LayeredTransportSolver (solver/layered.py)
  on the chosen device — a CUDA kernel on the card — and sends a graph
  that does not collapse to MegaSolver, else CsrSolver.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np

from ..graph.device_export import FlowProblem
from ..obs.soltel import SolverStallError  # noqa: F401 — re-exported


@dataclass
class FlowResult:
    """A feasible min-cost flow over a FlowProblem's arc slots.

    ``flow`` excludes lower-bound offsets; add ``problem.flow_offset`` to
    recover total arc flow. ``objective`` is the total cost including the
    lower-bound flow's cost.
    """

    flow: np.ndarray  # int64[M]
    objective: int
    iterations: int = 0

    def total_flow(self, problem: FlowProblem) -> np.ndarray:
        return self.flow + problem.flow_offset


def check_finite_costs(problem: FlowProblem) -> None:
    """Reject a poisoned cost model (NaN/inf costs) up front. Every
    backend calls this before its int cast — a non-finite float would
    otherwise wrap into garbage potentials and be "solved" silently
    (the chaos harness's nan_cost fault exists to catch exactly that;
    see runtime/chaos.poison_costs)."""
    if problem.cost.dtype.kind == "f" and not np.isfinite(problem.cost).all():
        raise ValueError(
            "non-finite arc costs in flow problem (NaN/inf from the "
            "cost model); refusing to solve"
        )


def lower_bound_cost(problem: FlowProblem) -> int:
    """Cost carried by the folded lower-bound flow; every backend adds
    this to its solved objective so objectives are comparable."""
    return int(
        (problem.flow_offset.astype(np.int64) * problem.cost.astype(np.int64)).sum()
    )


class FlowSolver(abc.ABC):
    """A min-cost max-flow backend over flat arrays."""

    @abc.abstractmethod
    def solve(self, problem: FlowProblem) -> FlowResult: ...

    def solve_traced(self, problem: FlowProblem) -> FlowResult:
        """``solve()`` inside a ``backend_solve`` obs span carrying the
        backend name, problem shape, and solver effort. This is the one
        instrumentation seam shared by every backend — the placement
        driver calls it, so each solve is a nested span in a captured
        trace. Costs two ``perf_counter`` reads when no tracer is
        installed.

        Backends that emit solver-interior telemetry (``last_telemetry``
        after a solve — the csr, ell and mega solves and the layered
        transport's plain loop) additionally get their ring decoded here:
        superstep histograms onto the registry, per-superstep child spans
        under this span, and the stall detector (obs/soltel.py)."""
        from ..obs import soltel
        from ..obs.spans import span

        with span(
            "backend_solve",
            backend=type(self).__name__,
            nodes=int(problem.num_nodes),
            arcs=int(problem.num_arcs),
        ) as sp:
            result = self.solve(problem)
            work = int(result.iterations or 0) or int(
                getattr(self, "last_iterations", 0)
                or getattr(self, "last_supersteps", 0)
                or 0
            )
            if work:
                sp.set("supersteps", work)
            tel = getattr(self, "last_telemetry", None)
            if tel is not None:
                soltel.publish(tel, sp)
        return result

    def reset(self) -> None:
        """Drop warm-start state (e.g. after a full graph rebuild)."""
