"""NativeSolver: the in-process C++ MCMF backend.

Role-equivalent to the reference's Flowlessly subprocess
(scheduling/flow/placement/solver.go:31-34,92-123): the production CPU
solver. Differences by design: in-process shared library instead of a
daemon + DIMACS pipes; warm start carried by an opaque price context
instead of daemon process state; solver failure raises instead of
panicking the scheduler (solver.go:98-108).

Algorithms (mirroring Flowlessly's --algorithm flag, solver.go:32):
  "ssp"          exact successive shortest paths — oracle-grade
  "cost_scaling" Goldberg-Tarjan push-relabel, warm-started across rounds
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..graph.device_export import FlowProblem
from .base import FlowResult, FlowSolver, check_finite_costs, lower_bound_cost

_ALGORITHMS = {"ssp": 0, "cost_scaling": 1}

_ERRORS = {
    1: "infeasible flow problem: supply cannot reach any demand "
    "(the unscheduled-aggregator escape arcs should prevent this)",
    2: "unbalanced excess: total supply != total demand",
    3: "malformed problem arrays",
    4: "negative cost cycle in flow network",
}


class NativeSolver(FlowSolver):
    def __init__(self, algorithm: str = "cost_scaling", warm_start: bool = True):
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}; want one of {sorted(_ALGORITHMS)}")
        from ..native import load_library

        self._lib = load_library()
        self._algorithm = _ALGORITHMS[algorithm]
        self._ctx = self._lib.ksched_mcmf_ctx_new() if warm_start else None
        self.last_iterations = 0

    def __del__(self):  # pragma: no cover - interpreter-shutdown dependent
        ctx = getattr(self, "_ctx", None)
        if ctx is not None:
            try:
                self._lib.ksched_mcmf_ctx_free(ctx)
            except Exception:
                pass
            self._ctx = None

    def reset(self) -> None:
        if self._ctx is not None:
            self._lib.ksched_mcmf_ctx_free(self._ctx)
            self._ctx = self._lib.ksched_mcmf_ctx_new()

    def solve(self, problem: FlowProblem) -> FlowResult:
        n = int(problem.num_nodes)
        m = len(problem.src)
        check_finite_costs(problem)
        src = np.ascontiguousarray(problem.src, dtype=np.int32)
        dst = np.ascontiguousarray(problem.dst, dtype=np.int32)
        cap = np.ascontiguousarray(problem.cap, dtype=np.int32)
        cost = np.ascontiguousarray(problem.cost, dtype=np.int32)
        excess = np.ascontiguousarray(problem.excess[:n], dtype=np.int64)
        flow = np.zeros(m, dtype=np.int64)
        objective = ctypes.c_int64(0)
        iters = ctypes.c_int64(0)

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        rc = self._lib.ksched_mcmf_solve(
            self._ctx,
            self._algorithm,
            n,
            m,
            p32(src),
            p32(dst),
            p32(cap),
            p32(cost),
            p64(excess),
            p64(flow),
            ctypes.byref(objective),
            ctypes.byref(iters),
        )
        if rc != 0:
            raise RuntimeError(_ERRORS.get(rc, f"native solver error {rc}"))
        self.last_iterations = int(iters.value)
        return FlowResult(
            flow=flow,
            objective=int(objective.value) + lower_bound_cost(problem),
            iterations=self.last_iterations,
        )
