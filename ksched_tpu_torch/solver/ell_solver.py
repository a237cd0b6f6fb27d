"""Bucketed-ELL push-relabel: the CSR solve without the global scans.

Port of ksched_tpu/solver/ell_solver.py (`"ell"` in solver/select.py).
Same algorithm as solver/csr_solver.py (synchronous cost-scaling
push-relabel with maximal pushes, price tightening and an eps=1 warm
attempt) on a different data layout. Scheduling flow graphs are
near-bipartite with a handful of aggregator hubs, so the doubled
residual entries are bucketed by degree:

- SMALL nodes (deg <= w_small) pack into one dense [Ns, w_small] entry
  block: per-node reductions are per-row reductions, the maximal-push
  prefix a w_small-wide row cumsum;
- HUB nodes row-split into a [Rh, w_hub] block; per-hub combines run
  over a tiny [Hn, Kmax] row-index matrix;
- per-node values assemble by gather from the block partials
  (node_kind/node_slot).

Any maximal-push allocation is a valid discharge, so flows and
objectives equal the CSR solver's optimum, though the per-node
allocation order (hence superstep counts) may differ. Everything is
int32 with wrap-around, bit-identical to the JAX package's
`_solve_mcmf_ell`.

There is no kernel here: the JAX package runs this solve as XLA, and
the port runs it as plain PyTorch on the tensors' device, one Python
iteration (one host read) per superstep. A device-resident problem
(graph/device_export.py) is solved on its persistent tensors with the
warm flow carried on the card. Every solve writes the soltel telemetry
ring by default (obs/soltel.py), as `_solve_mcmf_ell` does in the JAX
package: `last_telemetry`, and the stall reason on a SolverStallError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..analysis.marks import loop_mark
from ..graph.device_export import FlowProblem
from .base import (
    FlowResult,
    FlowSolver,
    SolverStallError,
    check_finite_costs,
    lower_bound_cost,
)

_I32 = torch.int32
_BIG = 1 << 30
_BIG_D = 1 << 28
_P_GUARD = 1 << 30


@dataclass
class EllPlan:
    """Host-prebuilt bucketed-ELL layout of the doubled residual entries."""

    # small block [Ns, Ws]: one row per small node
    s_node: np.ndarray  # int32[Ns]
    s_arc: np.ndarray  # int32[Ns, Ws] (0 on pad)
    s_sign: np.ndarray  # int32[Ns, Ws] +1/-1, 0 on pad
    s_peer: np.ndarray  # int32[Ns, Ws] (self on pad)
    # hub block [Rh, Wh]: hub nodes row-split in entry order
    h_node: np.ndarray  # int32[Rh]
    h_arc: np.ndarray  # int32[Rh, Wh]
    h_sign: np.ndarray  # int32[Rh, Wh]
    h_peer: np.ndarray  # int32[Rh, Wh]
    h_rowhub: np.ndarray  # int32[Rh] hub slot of each row
    h_rowk: np.ndarray  # int32[Rh] row's position within its hub
    # per-hub combine [Hn, K]
    hub_rows: np.ndarray  # int32[Hn, K] row indices (clamped on pad)
    hub_rows_valid: np.ndarray  # bool[Hn, K]
    hub_node: np.ndarray  # int32[Hn]
    # per-node assembly
    node_kind: np.ndarray  # int32[N] 0=empty 1=small 2=hub
    node_slot: np.ndarray  # int32[N] small-row index or hub slot
    # flow update: entry position of each arc's fwd/bwd entry in the
    # CONCATENATED flat delta array [Ns*Ws + Rh*Wh]
    fwd_flat: np.ndarray  # int32[M]
    bwd_flat: np.ndarray  # int32[M]
    src: np.ndarray  # int32[M] endpoints the plan was built for
    dst: np.ndarray  # int32[M]


def build_ell_plan(
    src: np.ndarray, dst: np.ndarray, num_nodes: int,
    w_small: int = 8, w_hub: int = 512,
) -> EllPlan:
    n = num_nodes
    m = len(src)
    node = np.concatenate([src, dst]).astype(np.int64)  # kschedlint: host-only (host numpy)
    peer = np.concatenate([dst, src]).astype(np.int32)
    arc = np.concatenate([np.arange(m), np.arange(m)]).astype(np.int32)
    sign = np.concatenate(
        [np.ones(m, np.int32), -np.ones(m, np.int32)]
    )
    deg = np.bincount(node, minlength=n)
    # in-node rank of every doubled entry, via stable node sort
    order = np.argsort(node, kind="stable")
    row_ptr = np.zeros(n + 1, np.int64)  # kschedlint: host-only (host numpy)
    row_ptr[1:] = np.cumsum(deg)
    rank = np.empty(2 * m, np.int64)  # kschedlint: host-only (host numpy)
    rank[order] = np.arange(2 * m) - row_ptr[node[order]]

    is_hub_node = deg > w_small
    small_ids = np.nonzero((deg > 0) & ~is_hub_node)[0]
    hub_ids = np.nonzero(is_hub_node)[0]
    ns = max(len(small_ids), 1)
    hn = max(len(hub_ids), 1)
    small_slot = np.full(n, 0, np.int64)  # kschedlint: host-only (host numpy)
    small_slot[small_ids] = np.arange(len(small_ids))
    hub_slot = np.full(n, 0, np.int64)  # kschedlint: host-only (host numpy)
    hub_slot[hub_ids] = np.arange(len(hub_ids))

    # hub row allocation: ceil(deg/w_hub) consecutive rows per hub
    hub_deg = deg[hub_ids] if len(hub_ids) else np.zeros(0, np.int64)  # kschedlint: host-only (host numpy)
    rows_per_hub = (hub_deg + w_hub - 1) // w_hub
    hub_row_start = np.zeros(len(hub_ids) + 1, np.int64)  # kschedlint: host-only (host numpy)
    hub_row_start[1:] = np.cumsum(rows_per_hub)
    rh = max(int(hub_row_start[-1]), 1)
    kmax = max(int(rows_per_hub.max()) if len(rows_per_hub) else 0, 1)

    s_node = np.zeros(ns, np.int32)
    s_node[: len(small_ids)] = small_ids
    s_arc = np.zeros((ns, w_small), np.int32)
    s_sign = np.zeros((ns, w_small), np.int32)
    s_peer = np.tile(s_node[:, None], (1, w_small)).astype(np.int32)
    h_node = np.zeros(rh, np.int32)
    h_rowhub = np.zeros(rh, np.int32)
    h_rowk = np.zeros(rh, np.int32)
    for i, hub in enumerate(hub_ids):
        r0, r1 = hub_row_start[i], hub_row_start[i + 1]
        h_node[r0:r1] = hub
        h_rowhub[r0:r1] = i
        h_rowk[r0:r1] = np.arange(r1 - r0)
    h_arc = np.zeros((rh, w_hub), np.int32)
    h_sign = np.zeros((rh, w_hub), np.int32)
    h_peer = np.tile(h_node[:, None], (1, w_hub)).astype(np.int32)

    # scatter entries into their block cells (host numpy, build-time only)
    e_small = ~is_hub_node[node]
    srow = small_slot[node[e_small]]
    scol = rank[e_small]
    s_arc[srow, scol] = arc[e_small]
    s_sign[srow, scol] = sign[e_small]
    s_peer[srow, scol] = peer[e_small]
    e_hub = ~e_small
    hrow = hub_row_start[hub_slot[node[e_hub]]] + rank[e_hub] // w_hub
    hcol = rank[e_hub] % w_hub
    h_arc[hrow, hcol] = arc[e_hub]
    h_sign[hrow, hcol] = sign[e_hub]
    h_peer[hrow, hcol] = peer[e_hub]

    # flat position of every doubled entry in concat([small, hub]) order
    flat = np.empty(2 * m, np.int64)  # kschedlint: host-only (host numpy)
    flat[e_small] = srow * w_small + scol
    flat[e_hub] = ns * w_small + hrow * w_hub + hcol

    hub_rows = np.zeros((hn, kmax), np.int32)
    hub_rows_valid = np.zeros((hn, kmax), bool)
    for i in range(len(hub_ids)):
        k = int(rows_per_hub[i])
        hub_rows[i, :k] = np.arange(hub_row_start[i], hub_row_start[i + 1])
        hub_rows_valid[i, :k] = True
    hub_node = np.zeros(hn, np.int32)
    hub_node[: len(hub_ids)] = hub_ids

    node_kind = np.where(
        deg == 0, 0, np.where(is_hub_node, 2, 1)
    ).astype(np.int32)
    node_slot = np.where(is_hub_node, hub_slot, small_slot).astype(np.int32)

    return EllPlan(
        s_node=s_node, s_arc=s_arc, s_sign=s_sign, s_peer=s_peer,
        h_node=h_node, h_arc=h_arc, h_sign=h_sign, h_peer=h_peer,
        h_rowhub=h_rowhub, h_rowk=h_rowk,
        hub_rows=hub_rows, hub_rows_valid=hub_rows_valid,
        hub_node=hub_node,
        node_kind=node_kind, node_slot=node_slot,
        fwd_flat=flat[:m].astype(np.int32),
        bwd_flat=flat[m:].astype(np.int32),
        src=src.copy(), dst=dst.copy(),
    )


def _take(table, idx):
    """table[idx] with idx clamped into range, as XLA's gather clamps:
    every out-of-range read here is discarded by a select."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]  # kschedlint: index-only (gather index)


def _solve_mcmf_ell(  # kschedlint: program=ell_solve
    cap, cost, supply, flow0, eps_init,
    s_node, s_arc, s_sign, s_peer,
    h_node, h_arc, h_sign, h_peer, h_rowhub, h_rowk,
    hub_rows, hub_rows_valid, hub_node, node_kind, node_slot,
    fwd_flat, bwd_flat, a_src, a_dst,
    alpha: int = 8,
    max_supersteps: int = 50_000,
    tighten_sweeps: int = 32,
    telemetry_cap: int = 0,
):
    """One bucketed-ELL solve: (flow int32[M], p int32[N], steps int32,
    converged bool, p_overflow bool) tensors on cap's device, equal to
    ksched_tpu's `_solve_mcmf_ell` bit for bit. Arguments as there:
    cap/cost/flow0 int32[M] (cost pre-scaled by the node count), supply
    int32[N], an EllPlan's tables (`plan_tensors`). telemetry_cap > 0
    appends the int32 [telemetry_cap, SOLTEL_WIDTH] soltel ring."""
    from ..obs import soltel
    kmax = hub_rows.shape[1]
    hub_rows_valid = hub_rows_valid.to(torch.bool)
    a_src, a_dst = a_src.long(), a_dst.long()  # kschedlint: index-only (gather index)
    s_nodel, h_nodel = s_node.long(), h_node.long()  # kschedlint: index-only (gather index)
    sc_s = s_sign * _take(cost, s_arc)  # signed cost per small entry
    sc_h = h_sign * _take(cost, h_arc)
    cap_s = _take(cap, s_arc)
    cap_h = _take(cap, h_arc)

    def i32sum(x, dim):
        return torch.sum(x, dim, dtype=_I32)

    def i32min(x, dim):
        return torch.amin(x, dim)

    def i32max(x, dim):
        return torch.amax(x, dim)

    def per_node(part_s, part_h_row, combine, identity):
        """A per-node [N] value assembled from the block partials by
        gather; `combine` reduces a hub's row partials."""
        hub_part = combine(
            torch.where(hub_rows_valid, _take(part_h_row, hub_rows), identity), 1)
        v = torch.where(node_kind == 2, _take(hub_part, node_slot),
                        _take(part_s, node_slot))
        return torch.where(node_kind == 0, identity, v)

    def residuals(flow):
        f_s = _take(flow, s_arc)
        f_h = _take(flow, h_arc)
        r_s = torch.where(s_sign > 0, cap_s - f_s, torch.where(s_sign < 0, f_s, 0))
        r_h = torch.where(h_sign > 0, cap_h - f_h, torch.where(h_sign < 0, f_h, 0))
        return r_s, r_h

    def excess_of(flow):
        out_s = i32sum(s_sign * _take(flow, s_arc), 1)
        out_h = i32sum(h_sign * _take(flow, h_arc), 1)
        return supply - per_node(out_s, out_h, i32sum, 0)

    def saturate(flow, p):
        rc_fwd = cost + p[a_src] - p[a_dst]
        return torch.where(rc_fwd < 0, cap, torch.where(rc_fwd > 0, 0, flow))

    def tighten(flow):
        excess0 = excess_of(flow)
        r_s, r_h = residuals(flow)
        d = torch.full_like(excess0, _BIG_D).masked_fill_(excess0 < 0, 0)
        changed, it = True, 0
        while changed and it < tighten_sweeps:
            loop_mark("sweep")
            cand_s = torch.where(r_s > 0, sc_s + _take(d, s_peer), _BIG_D)
            cand_h = torch.where(r_h > 0, sc_h + _take(d, h_peer), _BIG_D)
            best = per_node(i32min(cand_s, 1), i32min(cand_h, 1), i32min, _BIG_D)
            d2 = torch.clamp(torch.minimum(d, best), min=-_BIG_D)
            changed = bool((d2 != d).any())
            d, it = d2, it + 1
        loop_mark()
        return -torch.clamp(d, max=_BIG_D)

    def superstep(flow, p, eps, excess):
        r_s, r_h = residuals(flow)
        pp_s = _take(p, s_peer)
        pp_h = _take(p, h_peer)
        rc_s = sc_s + p[s_nodel][:, None] - pp_s
        rc_h = sc_h + p[h_nodel][:, None] - pp_h
        e_s = excess[s_nodel]
        e_h = excess[h_nodel]
        ra_s = torch.where((r_s > 0) & (rc_s < 0) & (e_s[:, None] > 0), r_s, 0)
        ra_h = torch.where((r_h > 0) & (rc_h < 0) & (e_h[:, None] > 0), r_h, 0)
        # maximal push: each node's excess over its admissible entries in
        # block order by exclusive prefix sums; hubs add a cross-row
        # offset (per-hub exclusive cumsum of row totals)
        pre_s = torch.cumsum(ra_s, 1, dtype=_I32) - ra_s
        row_tot = i32sum(ra_h, 1)
        hub_row_tot = torch.where(hub_rows_valid, _take(row_tot, hub_rows), 0)
        hub_excl = torch.cumsum(hub_row_tot, 1, dtype=_I32) - hub_row_tot
        row_off = _take(hub_excl.reshape(-1), h_rowhub.long() * kmax + h_rowk.long())  # kschedlint: index-only (gather index)
        pre_h = (torch.cumsum(ra_h, 1, dtype=_I32) - ra_h) + row_off[:, None]
        d_s = torch.minimum(torch.clamp(e_s[:, None] - pre_s, min=0), ra_s)
        d_h = torch.minimum(torch.clamp(e_h[:, None] - pre_h, min=0), ra_h)
        delta_flat = torch.cat([d_s.reshape(-1), d_h.reshape(-1)])
        new_flow = flow + _take(delta_flat, fwd_flat) - _take(delta_flat, bwd_flat)
        pushed = per_node(i32sum(d_s, 1), i32sum(d_h, 1), i32sum, 0)
        sum_r = per_node(i32sum(r_s, 1), i32sum(r_h, 1), i32sum, 0)
        cand_s = torch.where(r_s > 0, pp_s - sc_s, -_BIG)
        cand_h = torch.where(r_h > 0, pp_h - sc_h, -_BIG)
        best = per_node(i32max(cand_s, 1), i32max(cand_h, 1), i32max, -_BIG)
        relabel = (excess > 0) & (pushed == 0) & (sum_r > 0)
        new_p = torch.where(relabel, best - eps, p)
        if not telemetry_cap:
            return new_flow, new_p, ()
        # soltel cols 3..6; flow == cap <=> forward residual 0 (a
        # zero-cap arc counts), as in the CSR and mega counters
        aux = (
            torch.sum(pushed, dtype=_I32),
            torch.sum(relabel, dtype=_I32),
            torch.sum(flow >= cap, dtype=_I32),
            torch.sum(ra_s > 0, dtype=_I32) + torch.sum(ra_h > 0, dtype=_I32),
        )
        return new_flow, new_p, aux

    dev = cap.device
    tel = soltel.device_ring(telemetry_cap, dev) if telemetry_cap else None
    p = tighten(flow0)
    flow = saturate(flow0, p)
    eps, steps, done = int(eps_init), 0, False
    while not done and steps < max_supersteps:
        loop_mark("superstep")
        excess = excess_of(flow)
        if bool((excess > 0).any()):
            flow, p, aux = superstep(flow, p, eps, excess)
            if telemetry_cap:
                soltel.device_ring_write(tel, steps, soltel.device_row(
                    eps, torch.sum(excess > 0, dtype=_I32),
                    torch.sum(excess.clamp(min=0), dtype=_I32), *aux, device=dev))
            steps += 1
        elif eps <= 1:
            done = True
        else:
            flow = saturate(flow, p)
            eps = max(1, eps // alpha)
    loop_mark()
    converged = done and int(excess_of(flow).abs().max()) == 0
    p_overflow = int(p.abs().max()) >= _P_GUARD
    out = (
        flow, p, torch.tensor(steps, dtype=_I32, device=dev),
        torch.tensor(converged, dtype=torch.bool, device=dev),
        torch.tensor(p_overflow, dtype=torch.bool, device=dev),
    )
    return out + (tel,) if telemetry_cap else out


def plan_tensors(plan: EllPlan, device) -> tuple:
    """An EllPlan as `_solve_mcmf_ell`'s plan arguments on `device`."""
    return tuple(
        torch.as_tensor(x, device=device)
        for x in (
            plan.s_node, plan.s_arc, plan.s_sign, plan.s_peer,
            plan.h_node, plan.h_arc, plan.h_sign, plan.h_peer,
            plan.h_rowhub, plan.h_rowk,
            plan.hub_rows, plan.hub_rows_valid, plan.hub_node,
            plan.node_kind, plan.node_slot,
            plan.fwd_flat, plan.bwd_flat,
            plan.src.astype(np.int32), plan.dst.astype(np.int32),
        )
    )


class EllSolver(FlowSolver):
    """Bucketed-ELL cost-scaling push-relabel, warm-started across
    rounds: drop-in for CsrSolver with the scan-free layout (the JAX
    package's EllSolver). Attempt 1 runs from the previous round's flow
    on arcs whose endpoints are unchanged (eps 1, at most
    min(4096, max_supersteps) supersteps), attempt 2 cold. A
    device-resident problem is solved on its persistent tensors, its
    flow and endpoint tensors kept on the card for the next warm mask.
    Tensors live on ``device`` ("cuda" by default; it raises where there
    is no card)."""

    def __init__(self, alpha: int = 8, max_supersteps: int = 50_000,
                 warm_start: bool = True, w_small: int = 8, w_hub: int = 512,
                 telemetry: Optional[int] = None, device="cuda"):
        from ..utils.device import resolve_device
        from .layered import validate_alpha

        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.warm_start = warm_start
        self.w_small = w_small
        self.w_hub = w_hub
        #: soltel ring capacity; None = obs/soltel.resolve_cap's default
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._prev: Optional[np.ndarray] = None
        self._prev_dev: Optional[torch.Tensor] = None  # resident rounds
        #: endpoint tensors at the LAST SUCCESSFUL SOLVE (resident rounds)
        self._prev_src_dev: Optional[torch.Tensor] = None
        self._prev_dst_dev: Optional[torch.Tensor] = None
        self._plan: Optional[EllPlan] = None
        self._plan_dev: Optional[tuple] = None
        #: endpoint-generation key of the cached plan (FlowProblem.plan_key)
        self._plan_key = None
        self.last_supersteps = 0
        self.last_telemetry = None

    def reset(self) -> None:
        self._prev = None
        self._prev_dev = None
        self._prev_src_dev = None
        self._prev_dst_dev = None

    def _plan_for(self, src, dst, n, plan_key=None) -> tuple:
        plan = self._plan
        if plan_key is not None and self._plan_key == plan_key and plan is not None:
            return self._plan_dev  # generation key match: no scans at all
        if plan is None or len(plan.src) != len(src) or len(
            plan.node_kind
        ) != n or plan_key is not None or not (
            np.array_equal(plan.src, src) and np.array_equal(plan.dst, dst)
        ):
            plan = build_ell_plan(src, dst, n, w_small=self.w_small, w_hub=self.w_hub)
            self._plan = plan
            self._plan_dev = plan_tensors(plan, self.device)
        self._plan_key = plan_key
        return self._plan_dev

    def solve_async(self, problem: FlowProblem):
        n = problem.num_nodes
        m = len(problem.src)
        if m == 0 or problem.num_arcs == 0:
            if (problem.excess > 0).any():
                raise RuntimeError("infeasible flow problem: supply but no arcs")
            return (problem, None, None, None)
        check_finite_costs(problem)
        src = problem.src.astype(np.int32)
        dst = problem.dst.astype(np.int32)
        max_cost = int(np.abs(problem.cost).max()) if m else 0
        if max_cost * n >= (1 << 30):
            raise OverflowError(
                f"scaled costs overflow int32: max|cost|={max_cost} at {n} nodes")
        prev_plan = self._plan
        plan_dev = self._plan_for(src, dst, n, plan_key=getattr(problem, "plan_key", None))
        resident = getattr(problem, "d_cap", None) is not None
        if resident:
            from ..graph.device_export import resident_solver_inputs

            dev_args, flow0_dev, _warm = resident_solver_inputs(
                problem, self._prev_dev, self._prev_src_dev,
                self._prev_dst_dev, self.warm_start, self.device,
            )
        else:
            cap = problem.cap.astype(np.int32)
            supply = problem.excess.astype(np.int32)
            cost = problem.cost.astype(np.int32) * np.int32(n)
            dev_args = tuple(torch.as_tensor(x, device=self.device)
                             for x in (cap, cost, supply))
            flow0 = np.zeros(m, dtype=np.int32)
            if self.warm_start and self._prev is not None:
                f_prev = self._prev
                if len(f_prev) == m and prev_plan is not None and len(prev_plan.src) == m:
                    same = (prev_plan.src == src) & (prev_plan.dst == dst)
                    flow0 = np.where(same, np.minimum(f_prev, cap), 0).astype(np.int32)
            flow0_dev = torch.as_tensor(flow0, device=self.device)
        from ..obs import soltel

        tel_cap = soltel.resolve_cap(self.telemetry)
        out = _solve_mcmf_ell(
            *dev_args, flow0_dev, 1, *plan_dev, alpha=self.alpha,
            max_supersteps=min(4096, self.max_supersteps), telemetry_cap=tel_cap,
        )
        cold = max(1, max_cost * n)
        return (problem, out, (dev_args, plan_dev, cold, tel_cap), resident)

    def complete(self, pending) -> FlowResult:
        from ..obs import soltel

        problem, out, rest, resident = pending
        if out is None:
            self.last_telemetry = None
            return FlowResult(flow=np.zeros(len(problem.src), dtype=np.int64),  # kschedlint: host-only (FlowResult's int64 flow)
                              objective=0, iterations=0)
        dev_args, plan_dev, eps_cold, tel_cap = rest
        flow, p, steps, converged, p_overflow, *ring = out
        if not (bool(converged) and not bool(p_overflow)):
            zeros = torch.zeros(len(problem.src), dtype=_I32, device=dev_args[0].device)
            flow, p, steps, converged, p_overflow, *ring = _solve_mcmf_ell(
                *dev_args, zeros, eps_cold, *plan_dev, alpha=self.alpha,
                max_supersteps=self.max_supersteps, telemetry_cap=tel_cap,
            )
        self.last_supersteps = int(steps)
        # the final attempt's ring; its budget is the solver's
        self.last_telemetry = soltel.decode(
            ring[0], int(steps), tel_cap, "ell", self.max_supersteps,
            converged=bool(converged) and not bool(p_overflow),
            nodes=problem.num_nodes, arcs=len(problem.src),
        ) if ring else None
        if bool(p_overflow) or not bool(converged):
            self.reset()
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
        flow_np = flow.cpu().numpy()
        if self.warm_start:
            self._prev = flow_np.astype(np.int32)
            self._prev_dev = flow if resident else None
            self._prev_src_dev = problem.d_src if resident else None
            self._prev_dst_dev = problem.d_dst if resident else None
        objective = int(
            (flow_np.astype(np.int64) * problem.cost.astype(np.int64)).sum()  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
        ) + lower_bound_cost(problem)
        return FlowResult(flow=flow_np.astype(np.int64), objective=objective,  # kschedlint: host-only (FlowResult's int64 flow)
                          iterations=int(steps))

    def solve(self, problem: FlowProblem) -> FlowResult:
        return self.complete(self.solve_async(problem))


from ..analysis.program_registry import declare_programs as _declare_programs  # noqa: E402

_declare_programs(__name__, "ell_solve")
