"""MegaSolver: the general-graph MCMF backend on one kernel launch.

Port of ksched_tpu/solver/mega_solver.py. Same FlowSolver seam, same
algorithm and same host-cached `build_csr_plan` ordering as
solver/csr_solver.py, but the whole superstep loop runs in one launch
of the CUDA kernel ops/mcmf.py `mcmf_loop` (kernel B3), over entry
tables that stay in the card's L2 for the solve. Flows are
bit-identical to the CSR solver's.

The kernel's reach is bounded by its live set (`mega_fits`, a budget
tied to the 50 MB L2 in place of the TPU's VMEM): `fits()` refuses
larger graphs, graphs whose scaled costs overflow int32 and graphs with
an isolated node that carries excess. A standalone MegaSolver
(make_backend("mega")) delegates a refused solve to its `fallback` CSR
solver; under AutoSolver (solver/graph_collapse.py) the refusal sends
the solve to the CSR rung — the dense -> mega -> CSR ladder.

The plan adds to the CSR ordering, all from the structure alone: the
partner permutation (each entry's reverse twin), segment start and end
flags, and padding to the [R, MEGA_LANES] tiling, the pad entries one
inert trailing segment (sign 0, supply 0, partner self).

A device-resident problem (graph/device_export.py DeviceResidentProblem)
whose pow2 extents already meet the kernel's 256 floor is launched on
the mirror's own tensors (cap, scaled cost, supply) with the warm flow
derived on the card; smaller ones take the host path.

Every solve writes the soltel telemetry ring by default (obs/soltel.py;
kernel B3 writes it on the card, its plain version on the CPU), its
length clamped by `mega_telemetry_cap` as in the JAX package:
`last_telemetry` (the fallback's, on a delegated solve), and the stall
reason on a SolverStallError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..graph.device_export import FlowProblem
from ..utils import next_pow2
from .base import (
    FlowResult,
    FlowSolver,
    SolverStallError,
    check_finite_costs,
    lower_bound_cost,
)
from .csr_solver import CsrPlan, build_csr_plan


def _pad_pow2(x: np.ndarray, floor: int = 256) -> np.ndarray:
    """Zero-pad a 1D array to a power-of-two length (>= floor), as the
    JAX package pads its kernel's arguments. Padded arc slots are never
    referenced by a live entry; padded node slots carry zero supply."""
    p = max(floor, next_pow2(len(x)))
    if p == len(x):
        return x
    return np.concatenate([x, np.zeros(p - len(x), x.dtype)])


@dataclass
class MegaPlan:
    """Padded, partner-linked entry tables for the kernel."""

    R: int  # block rows of the [R, L] entry tiling
    L: int  # lanes
    e_arc: np.ndarray  # int32[R*L] arc slot (0 on pad)
    e_sign: np.ndarray  # int32[R*L] +1/-1, 0 on pad
    e_src: np.ndarray  # int32[R*L] source node (0 on pad)
    e_hs: np.ndarray  # int32[R*L] segment-start flags
    e_he: np.ndarray  # int32[R*L] segment-end flags
    e_prow: np.ndarray  # int32[R*L] partner block row
    e_pcol: np.ndarray  # int32[R*L] partner lane
    fwd_pos: np.ndarray  # int32[M] flat entry position of each arc's fwd entry
    src: np.ndarray  # int32[M] endpoints the plan was built for
    dst: np.ndarray  # int32[M]


def build_mega_plan(plan: CsrPlan, lanes: Optional[int] = None) -> MegaPlan:
    """Derive the kernel's tables from a (cached) CsrPlan."""
    from ..ops.mcmf import MEGA_LANES, mega_entry_rows

    L = MEGA_LANES if lanes is None else lanes
    m2 = len(plan.s_arc)
    m = m2 // 2
    R = mega_entry_rows(m2, L)
    E = R * L
    pad = E - m2

    e_arc = np.zeros(E, np.int32)
    e_arc[:m2] = plan.s_arc
    e_sign = np.zeros(E, np.int32)
    e_sign[:m2] = plan.s_sign
    e_src = np.zeros(E, np.int32)
    e_src[:m2] = plan.s_src
    e_hs = np.zeros(E, np.int32)
    e_hs[:m2] = plan.s_isstart
    e_he = np.zeros(E, np.int32)
    if m2:
        e_he[: m2 - 1] = plan.s_isstart[1:]
        e_he[m2 - 1] = 1
    if pad:
        e_hs[m2] = 1  # the pad region is one inert segment
        e_he[E - 1] = 1

    # partner permutation: entry (u, v) of arc a pairs with (v, u) —
    # the fwd entry's twin is original entry a + m, and vice versa
    ppos = np.arange(E, dtype=np.int64)  # kschedlint: host-only (host numpy)
    ppos[:m2] = plan.inv_order[
        np.where(plan.s_sign > 0, plan.s_arc + m, plan.s_arc)
    ]
    e_prow = (ppos // L).astype(np.int32)
    e_pcol = (ppos % L).astype(np.int32)

    return MegaPlan(
        R=R, L=L,
        e_arc=e_arc, e_sign=e_sign, e_src=e_src,
        e_hs=e_hs, e_he=e_he, e_prow=e_prow, e_pcol=e_pcol,
        fwd_pos=plan.inv_order[:m].astype(np.int32),
        src=plan.src.copy(), dst=plan.dst.copy(),
    )


class MegaSolver(FlowSolver):
    """The kernel's push-relabel, warm-started across rounds: drop-in
    for CsrSolver on graphs that fit the kernel's budget.

    Attempt 1 runs from the previous round's flow on arcs whose
    endpoints are unchanged (eps 1, at most min(4096, max_supersteps)
    supersteps); if it does not converge, attempt 2 runs cold, from zero
    flow at eps max|cost|·n. `fallback` is an optional FlowSolver for
    the graphs `fits()` refuses; without one a refused solve raises.
    Tensors live on ``device`` ("cuda" by default: the kernel; "cpu":
    its plain version)."""

    def __init__(
        self,
        alpha: int = 8,
        max_supersteps: int = 50_000,
        warm_start: bool = True,
        budget_bytes: Optional[int] = None,
        fallback: Optional[FlowSolver] = None,
        telemetry: Optional[int] = None,
        device="cuda",
    ):
        from ..ops.mcmf import MEGA_BUDGET_BYTES
        from ..utils.device import resolve_device
        from .layered import validate_alpha

        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.warm_start = warm_start
        self.budget_bytes = (
            MEGA_BUDGET_BYTES if budget_bytes is None else int(budget_bytes)
        )
        self.fallback = fallback
        #: soltel ring capacity; None = obs/soltel.resolve_cap's default
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._prev: Optional[np.ndarray] = None
        self._plan: Optional[MegaPlan] = None
        self._plan_dev: Optional[tuple] = None
        #: endpoint-generation key of the cached plan (FlowProblem.
        #: plan_key): equal keys skip the O(M) endpoint scans entirely
        self._plan_key = None
        self._fits_ok_for: Optional[FlowProblem] = None
        self._prev_dev = None  # warm flow on the card (resident rounds)
        #: endpoint tensors at the LAST SUCCESSFUL SOLVE (resident rounds)
        self._prev_src_dev = None
        self._prev_dst_dev = None
        self.last_supersteps = 0
        self.last_telemetry = None
        self.last_refusal = ""

    def reset(self) -> None:
        self._prev = None
        self._prev_dev = None
        self._prev_src_dev = None
        self._prev_dst_dev = None
        if self.fallback is not None:
            self.fallback.reset()

    def fits(self, problem: FlowProblem) -> bool:
        """Whether the kernel can take this solve; on refusal
        `last_refusal` names why (the AutoSolver ladder reads it)."""
        from ..obs import soltel
        from ..ops.mcmf import mega_fits

        m = len(problem.src)
        if m == 0 or problem.num_arcs == 0:
            self.last_refusal = "empty graph"
            return False
        if not mega_fits(2 * m, budget_bytes=self.budget_bytes,
                         telemetry=soltel.resolve_cap(self.telemetry) > 0):
            self.last_refusal = (
                f"{2 * m} entries exceed the kernel's L2 budget "
                f"({self.budget_bytes} bytes)"
            )
            return False
        # costs pre-scaled by the node count must fit int32 (the CSR
        # solver's exactness contract); refusing keeps the ladder total
        max_cost = int(np.abs(problem.cost).max())
        if max_cost * problem.num_nodes >= (1 << 30):
            self.last_refusal = (
                f"scaled costs overflow int32 (max|cost|={max_cost} at "
                f"{problem.num_nodes} nodes)"
            )
            return False
        # a node with excess but no entries has no segment in the
        # kernel, so its (infeasible) excess would go unnoticed
        deg = np.bincount(
            np.concatenate([problem.src, problem.dst]),
            minlength=problem.num_nodes,
        )
        if (np.asarray(problem.excess)[deg == 0] != 0).any():
            self.last_refusal = "isolated node with nonzero excess"
            return False
        self.last_refusal = ""
        # the vetted problem (by identity): fits() then solve() audits once
        self._fits_ok_for = problem
        return True

    def _plan_for(self, src, dst, n, plan_key=None) -> tuple:
        plan = self._plan
        if plan_key is not None and self._plan_key == plan_key and plan is not None:
            return self._plan_dev  # generation key match: no scans at all
        if plan is None or len(plan.src) != len(src) or plan_key is not None or not (
            np.array_equal(plan.src, src) and np.array_equal(plan.dst, dst)
        ):
            plan = build_mega_plan(build_csr_plan(src, dst, n))
            self._plan = plan
            self._plan_dev = tuple(
                torch.as_tensor(x, device=self.device)
                for x in (
                    plan.e_arc, plan.e_sign, plan.e_src,
                    plan.e_hs, plan.e_he, plan.e_prow, plan.e_pcol,
                    _pad_pow2(plan.fwd_pos),
                )
            )
        self._plan_key = plan_key
        return self._plan_dev

    def _launch(self, args, flow0, eps, plan_dev, RL, budget, tel_cap):
        """One kernel solve: (flow, steps, converged, p_overflow, ring or
        None)."""
        from .. import ops

        out = ops.mcmf_solve(
            *args, torch.as_tensor(flow0, device=self.device), eps, *plan_dev,
            *RL, alpha=self.alpha, max_supersteps=budget, telemetry_cap=tel_cap,
        )
        return out if tel_cap else out + (None,)

    def solve_async(self, problem: FlowProblem):
        """Launch attempt 1; complete() runs attempt 2 if it failed."""
        n = problem.num_nodes
        m = len(problem.src)
        if m == 0 or problem.num_arcs == 0:
            if (problem.excess > 0).any():
                raise RuntimeError("infeasible flow problem: supply but no arcs")
            return (problem, None, None, None)
        check_finite_costs(problem)
        vetted = self._fits_ok_for is problem
        self._fits_ok_for = None
        if not vetted and not self.fits(problem):
            if self.fallback is None:
                raise RuntimeError(
                    f"the mcmf kernel refused the graph ({self.last_refusal}) "
                    "and no fallback solver is attached"
                )
            return (problem, None, None, self.fallback.solve_async(problem))
        self._fits_ok_for = None  # vetting is single-use
        src = problem.src.astype(np.int32)
        dst = problem.dst.astype(np.int32)
        max_cost = int(np.abs(problem.cost).max())

        prev_plan = self._plan
        plan_dev = self._plan_for(
            src, dst, n, plan_key=getattr(problem, "plan_key", None)
        )
        # a resident handle is consumable as it is only when its pow2
        # extents already meet _pad_pow2's 256 floor: then the padded
        # shapes ARE the resident shapes and nothing is re-uploaded
        resident = (
            getattr(problem, "d_cap", None) is not None
            and m >= 256
            and n >= 256
        )
        if resident:
            from ..graph.device_export import resident_solver_inputs

            args, flow0, _warm = resident_solver_inputs(
                problem, self._prev_dev, self._prev_src_dev,
                self._prev_dst_dev, self.warm_start, self.device,
            )
        else:
            cap = problem.cap.astype(np.int32)
            supply = problem.excess.astype(np.int32)
            cost = problem.cost.astype(np.int32) * np.int32(n)
            args = tuple(
                torch.as_tensor(_pad_pow2(x), device=self.device)
                for x in (cap, cost, supply)
            )
            flow0 = np.zeros(m, dtype=np.int32)
            if self.warm_start and self._prev is not None:
                f_prev = self._prev
                if len(f_prev) == m and prev_plan is not None and len(prev_plan.src) == m:
                    same = (prev_plan.src == src) & (prev_plan.dst == dst)
                    flow0 = np.where(same, np.minimum(f_prev, cap), 0).astype(np.int32)
            flow0 = _pad_pow2(flow0)
        RL = (self._plan.R, self._plan.L)
        from ..obs import soltel
        from ..ops.mcmf import mega_telemetry_cap

        tel_cap = soltel.resolve_cap(self.telemetry)
        if tel_cap:
            # the ring is clamped to one [R, L] table; decode needs the
            # effective cap
            tel_cap = mega_telemetry_cap(*RL, tel_cap)
        out = self._launch(args, flow0, 1, plan_dev, RL,
                           min(4096, self.max_supersteps), tel_cap)
        cold = (_pad_pow2(np.zeros(m, dtype=np.int32)), max(1, max_cost * n))
        return (problem, out, (args, plan_dev, RL, cold, resident, tel_cap), None)

    def complete(self, pending) -> FlowResult:
        from ..obs import soltel

        problem, out, rest, delegated = pending
        if delegated is not None:
            res = self.fallback.complete(delegated)
            self.last_supersteps = getattr(
                self.fallback, "last_supersteps", res.iterations
            )
            self.last_telemetry = getattr(self.fallback, "last_telemetry", None)
            return res
        if out is None:
            self.last_telemetry = None
            return FlowResult(
                flow=np.zeros(len(problem.src), dtype=np.int64),  # kschedlint: host-only (FlowResult's int64 flow)
                objective=0, iterations=0,
            )
        args, plan_dev, RL, (f0_cold, eps_cold), resident, tel_cap = rest
        flow, steps, converged, p_overflow, tel_buf = out
        if not (bool(converged) and not bool(p_overflow)):
            flow, steps, converged, p_overflow, tel_buf = self._launch(
                args, f0_cold, eps_cold, plan_dev, RL, self.max_supersteps, tel_cap)
        self.last_supersteps = int(steps)
        # the final attempt's ring; its budget is the solver's
        self.last_telemetry = soltel.decode(
            tel_buf, int(steps), tel_cap, "mega", self.max_supersteps,
            converged=bool(converged) and not bool(p_overflow),
            nodes=problem.num_nodes, arcs=len(problem.src),
        ) if tel_buf is not None else None
        if bool(p_overflow) or not bool(converged):
            self._prev = None
            self._prev_dev = None
        if bool(p_overflow):
            raise OverflowError("push-relabel potentials approached int32 range")
        if not bool(converged):
            tel = self.last_telemetry
            raise SolverStallError(
                f"push-relabel did not converge within {self.max_supersteps} "
                "supersteps; the flow problem may be infeasible",
                reason=soltel.detect_stall(tel) if tel is not None else None,
                telemetry=tel,
            )
        flow_np = flow[: len(problem.src)].cpu().numpy()
        if self.warm_start:
            self._prev = flow_np.astype(np.int32)
            # the kernel's flow lines up with the resident extent only
            # when no _pad_pow2 padding was applied
            keep = resident and flow.shape[0] == len(problem.src)
            self._prev_dev = flow if keep else None
            self._prev_src_dev = problem.d_src if keep else None
            self._prev_dst_dev = problem.d_dst if keep else None
        objective = int(
            (flow_np.astype(np.int64) * problem.cost.astype(np.int64)).sum()  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
        ) + lower_bound_cost(problem)
        return FlowResult(
            flow=flow_np.astype(np.int64), objective=objective,  # kschedlint: host-only (FlowResult's int64 flow)
            iterations=int(steps),
        )

    def solve(self, problem: FlowProblem) -> FlowResult:
        return self.complete(self.solve_async(problem))
