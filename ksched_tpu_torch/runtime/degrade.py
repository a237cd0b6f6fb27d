"""The solver degradation ladder.

The reference's loop dies with its solver: any solver failure (real
non-convergence, an overflow, a poisoned cost input) kills the round
and the process. Production schedulers degrade instead (Firmament runs
a fallback scheduler when the flow solver misbehaves): here the ladder
tries the configured backend, then steps down through cheaper/safer
rungs (the scan-CSR solver, the exact `cpu_ref` oracle), and only when
*every* rung fails raises `LadderExhausted` — which the scheduler
service catches and turns into a NOOP round that keeps the previous
assignments instead of crashing.

The ladder also hosts the chaos seam: a `FaultInjector` (see chaos.py)
can schedule per-rung faults — forced non-convergence, a backend
exception, NaN'd cost inputs — which exercise exactly the paths real
faults take.

Port of ksched_tpu/runtime/degrade.py. The rung names are the JAX
package's: "jax" is the scan-CSR CsrSolver on the ladder's device.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Tuple

import torch

from ..graph.device_export import FlowProblem
from ..obs.metrics import get_registry
from ..ops.build import KernelError
from ..solver.base import FlowResult, FlowSolver
from .chaos import ChaosBackendError, FaultInjector, poison_costs

from .integrity import IntegrityError

#: failures a rung may raise that the ladder absorbs: non-convergence /
#: infeasibility (RuntimeError), scaled-cost or potential overflow
#: (OverflowError et al.), rejected inputs (ValueError), and state-
#: integrity failures (IntegrityError — an AssertionError subclass, so
#: it must be named explicitly): the divergence response ladder
#: (runtime/integrity.py) repairs in place, but if a repair itself
#: raises through a solve, the rung steps down and the NOOP round is
#: the documented last rung of the divergence ladder. Anything else
#: (KeyboardInterrupt, MemoryError, bugs raising TypeError) propagates.
DEGRADABLE_ERRORS = (RuntimeError, ValueError, ArithmeticError, IntegrityError)

#: RuntimeErrors the ladder never absorbs: a kernel that does not build,
#: load or launch (ops/build.py KernelError) and an error the CUDA
#: runtime reports through torch. Stepping down would hide a broken
#: card path behind a slower rung; the round fails instead.
KERNEL_ERRORS = (KernelError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def is_kernel_failure(e: BaseException) -> bool:
    """Whether `e` is a kernel or CUDA runtime failure (older torch
    reports the latter as a plain RuntimeError naming a CUDA error)."""
    return isinstance(e, KERNEL_ERRORS) or (
        isinstance(e, RuntimeError) and str(e).startswith("CUDA error"))


class LadderExhausted(RuntimeError):
    """Every rung of the degradation ladder failed this round.

    `reasons` carries one STRUCTURED reason per failed rung
    (obs/soltel.failure_reason): the stall detector's verdict with the
    final supersteps of telemetry when the failure was a genuine
    non-convergence, a classified error otherwise — what the flight
    recorder dumps instead of a bare timeout string."""

    def __init__(
        self,
        failures: List[Tuple[str, BaseException]],
        reasons: Optional[List[dict]] = None,
    ) -> None:
        self.failures = failures
        self.reasons = reasons or []
        detail = "; ".join(f"{name}: {err}" for name, err in failures)
        super().__init__(f"all solver rungs failed: {detail}")


class DegradingSolver(FlowSolver):
    """A FlowSolver that tries rungs in order until one converges.

    ``rungs`` is a list of (name, backend_or_factory); factories are
    called lazily on first use so fallback backends cost nothing until
    a fault actually occurs. ``device`` is where the ladder's device
    work lives (a device-resident mirror reads it); by default the
    configured rung's own ``device``, else "cuda".
    """

    def __init__(
        self,
        rungs: List[Tuple[str, object]],
        injector: Optional[FaultInjector] = None,
        device=None,
    ) -> None:
        if not rungs:
            raise ValueError("degradation ladder needs at least one rung")
        self._rungs: List[Tuple[str, object]] = list(rungs)
        self.injector = injector
        self.device = device if device is not None else getattr(
            rungs[0][1], "device", "cuda")
        self.degradations_total = 0
        self.last_degradations = 0
        self.last_rung = -1
        self.last_rung_name: Optional[str] = None
        #: structured reasons (obs/soltel.failure_reason) for the rungs
        #: that failed during the LAST solve, in failure order
        self.last_failure_reasons: List[dict] = []
        # obs handles resolve at construction time (scoped_registry works)
        reg = get_registry()
        self._m_degradations = reg.counter(
            "ksched_degradations_total",
            "solver rungs stepped down, by the rung that failed",
            labelnames=("rung",),
        )
        self._m_exhausted = reg.counter(
            "ksched_ladder_exhausted_total",
            "rounds on which every solver rung failed (NOOP rounds)",
        )
        self._m_rung = reg.gauge(
            "ksched_solver_rung",
            "ladder rung that produced the last solve (-1 = none yet)",
        )
        self._m_rung.set(self.last_rung)  # -1 until the first solve lands

    # -- rung access -------------------------------------------------------

    def rung_names(self) -> List[str]:
        return [name for name, _ in self._rungs]

    def _backend(self, i: int) -> FlowSolver:
        name, b = self._rungs[i]
        if not isinstance(b, FlowSolver) and callable(b):
            b = b()
            if not isinstance(b, FlowSolver):
                raise TypeError(f"rung {name!r} factory returned {type(b).__name__}")
            self._rungs[i] = (name, b)
        return b

    @property
    def primary(self) -> FlowSolver:
        """The configured (first-rung) backend."""
        return self._backend(0)

    # -- FlowSolver --------------------------------------------------------

    def _begin_solve(self) -> List[Tuple[str, BaseException]]:
        self.last_degradations = 0
        self.last_rung = -1
        self.last_rung_name = None
        self.last_failure_reasons = []
        self.last_telemetry = None
        return []

    def _rung_problem(self, i: int, name: str, problem: FlowProblem) -> FlowProblem:
        """Apply this rung's scheduled chaos fault (if any) — raising
        for exception/nonconvergence faults, poisoning for nan_cost."""
        fault = self.injector.solver_fault(i) if self.injector else None
        if fault == "exception":
            raise ChaosBackendError(f"chaos: injected backend exception ({name})")
        if fault == "nonconverge":
            raise RuntimeError(f"chaos: forced non-convergence ({name})")
        if fault == "nan_cost":
            return poison_costs(problem)
        return problem

    def _note_rung_failure(
        self,
        i: int,
        name: str,
        e: BaseException,
        failures: List[Tuple[str, BaseException]],
    ) -> None:
        from ..obs import soltel

        failures.append((name, e))
        # structured reason instead of a bare timeout: the stall
        # detector's verdict (+ the final supersteps of telemetry)
        # lands in the soltel ring that every flight dump embeds, and
        # rides LadderExhausted.reasons
        reason = soltel.failure_reason(name, e)
        self.last_failure_reasons.append(
            soltel.note_stall(reason, getattr(e, "telemetry", None))
        )
        self.degradations_total += 1
        self.last_degradations += 1
        self._m_degradations.labels(rung=name).inc()
        nxt = self._rungs[i + 1][0] if i + 1 < len(self._rungs) else None
        warnings.warn(
            f"solver rung {name!r} failed "
            f"({reason.get('kind', 'error')}: {e}); "
            + (f"degrading to {nxt!r}" if nxt else "ladder exhausted"),
            RuntimeWarning,
            stacklevel=3,
        )

    def _finish_rung(self, i: int, name: str) -> None:
        self.last_rung = i
        self.last_rung_name = name
        self._m_rung.set(i)

    def _solve_from(
        self,
        start: int,
        problem: FlowProblem,
        failures: List[Tuple[str, BaseException]],
    ) -> FlowResult:
        for i in range(start, len(self._rungs)):
            name = self._rungs[i][0]
            try:
                p = self._rung_problem(i, name, problem)
                # solve_traced: each rung attempt — including a failing
                # one — is a nested backend_solve span in the trace
                result = self._backend(i).solve_traced(p)
            except DEGRADABLE_ERRORS as e:
                if is_kernel_failure(e):
                    raise
                self._note_rung_failure(i, name, e, failures)
                continue
            self._finish_rung(i, name)
            return result
        self._m_exhausted.inc()
        raise LadderExhausted(failures, reasons=list(self.last_failure_reasons))

    def solve(self, problem: FlowProblem) -> FlowResult:
        return self._solve_from(0, problem, self._begin_solve())

    # -- pipelined dispatch ------------------------------------------------

    def solve_async(self, problem: FlowProblem):
        """Dispatch the CONFIGURED rung without synchronizing, so a
        pipelined round can overlap host work with the in-flight solve.
        Any rung failure — at dispatch or at complete() — degrades
        through the remaining rungs SYNCHRONOUSLY inside complete():
        the pipelined loop falls back to the synchronous path on a rung
        failure rather than attempting to re-pipeline a degraded round.
        Fault draws, degradation counters, and the failure-reason ring
        behave exactly as in solve() (same per-round injector plan,
        same rung order)."""
        failures = self._begin_solve()
        name = self._rungs[0][0]
        try:
            p = self._rung_problem(0, name, problem)
            b = self._backend(0)
            if hasattr(b, "solve_async"):
                return (problem, "pending", b.solve_async(p), failures)
            return (problem, "done", b.solve_traced(p), failures)
        except DEGRADABLE_ERRORS as e:
            if is_kernel_failure(e):
                raise
            self._note_rung_failure(0, name, e, failures)
            return (problem, "failed", None, failures)

    def complete(self, token) -> FlowResult:
        """Synchronize a solve_async dispatch; on failure, degrade
        through the remaining rungs synchronously."""
        problem, kind, payload, failures = token
        if kind == "done":
            self._finish_rung(0, self._rungs[0][0])
            return payload
        if kind == "pending":
            name = self._rungs[0][0]
            b = self._backend(0)
            try:
                result = b.complete(payload)
            except DEGRADABLE_ERRORS as e:
                if is_kernel_failure(e):
                    raise
                self._note_rung_failure(0, name, e, failures)
            else:
                self._finish_rung(0, name)
                # async completions bypass solve_traced, so the caller
                # (solver/placement.py) publishes solver-interior
                # telemetry from last_telemetry — surface the rung's
                self.last_telemetry = getattr(b, "last_telemetry", None)
                return result
        return self._solve_from(1, problem, failures)

    def reset(self) -> None:
        # only instantiated rungs carry warm state worth dropping
        for _, b in self._rungs:
            if isinstance(b, FlowSolver):
                b.reset()

    # -- trace plumbing ----------------------------------------------------

    @property
    def last_iterations(self) -> int:
        """Solver effort of the rung that actually produced the round
        (RoundTracer reads this through the placement driver)."""
        if self.last_rung < 0:
            return 0
        b = self._rungs[self.last_rung][1]
        return getattr(b, "last_iterations", 0) or getattr(b, "last_supersteps", 0)


def build_degradation_ladder(
    configured: FlowSolver,
    configured_name: str = "configured",
    injector: Optional[FaultInjector] = None,
    make_backend: Optional[Callable[..., FlowSolver]] = None,
    device="cuda",
) -> DegradingSolver:
    """configured backend → scan-CSR solver ("jax", on `device`) →
    cpu_ref oracle.

    Rungs already covered by the configured backend are skipped (a
    configured "jax" does not get a second jax rung). Fallback rungs are
    lazy factories: nothing is built until a degradation fires.
    """
    if make_backend is None:
        from ..solver.select import make_backend as make_backend_default

        make_backend = make_backend_default
    rungs: List[Tuple[str, object]] = [(configured_name, configured)]
    cls = type(configured).__name__
    if cls != "CsrSolver" and configured_name != "jax":
        rungs.append(("jax", lambda: make_backend("jax", device=device)))
    if cls != "ReferenceSolver" and configured_name != "ref":
        rungs.append(("cpu_ref", lambda: make_backend("ref", device=device)))
    return DegradingSolver(rungs, injector=injector,
                           device=getattr(configured, "device", device))
