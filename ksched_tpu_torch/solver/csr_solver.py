"""The scan-CSR MCMF backend: cost-scaling push-relabel in PyTorch.

Port of ksched_tpu/solver/jax_solver.py (`CsrPlan`, `build_csr_plan`,
`_solve_mcmf`, `JaxSolver`'s non-resident policy). Arcs are doubled
into residual entries (forward + backward) sorted by source node; each
superstep every active node pushes along all its admissible entries at
once (an in-segment prefix sum allocates its excess front to back) and
an active node with no admissible entry relabels; phases shrink eps by
alpha down to 1 on costs pre-scaled by the node count, where the flow
is exactly optimal. Everything is int32 with wrap-around, as in the JAX
package: flows, potentials, superstep counts and convergence flags are
bit-identical to `_solve_mcmf`'s.

There is no kernel here: the JAX package runs this solve as XLA, and
the port runs it as plain PyTorch on the tensors' device, one Python
iteration (and one host read of the "any node active" flag) per
superstep, one read per tightening sweep and a few per solve
(`_solve_mcmf.reads` counts them). It is the mega backend's fallback
and AutoSolver's CSR rung; the fused solve is ops/mcmf.py (kernel B3).

Problems from a DeviceGraphState carry a slot-stable plan
(graph/slot_plan.py), which CsrSolver consumes by default, as the JAX
package's JaxSolver does; a device-resident problem
(graph/device_export.py DeviceResidentProblem) is solved on its
persistent tensors with the warm flow carried on the card.

Every solve writes the soltel telemetry ring by default (obs/soltel.py;
`telemetry=0` or KSCHED_SOLTEL=0 turns it off): `last_telemetry` holds
the last attempt's decoded ring, a stall raises SolverStallError with
the stall detector's reason and the ring, and a warm attempt that burns
its budget is reported as a `warm_price_war` event. The carried warm
state leaves and re-enters a solver as host arrays
(`export_warm_state` / `import_warm_state`, the warm-restore manifest of
runtime/checkpoint.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

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
_BIG_D = 1 << 28  # "unreachable" distance sentinel for price tightening
_P_GUARD = 1 << 30  # potential magnitude beyond this risks int32 overflow


@dataclass
class CsrPlan:
    """Host-prebuilt ordering of the doubled residual entries by source
    node, with everything the solve needs for segment reductions."""

    s_arc: np.ndarray  # int32[2M] arc slot per sorted entry
    s_sign: np.ndarray  # int32[2M] +1 forward, -1 backward
    s_src: np.ndarray  # int32[2M]
    s_dst: np.ndarray  # int32[2M]
    s_segstart: np.ndarray  # int32[2M] sorted index of the entry's segment start
    s_isstart: np.ndarray  # bool[2M] segment-start flags
    inv_order: np.ndarray  # int32[2M] sorted position of original entry j
    node_first: np.ndarray  # int32[N] row_ptr[:-1] clamped
    node_last: np.ndarray  # int32[N] row_ptr[1:]-1 clamped
    node_nonempty: np.ndarray  # bool[N]
    src: np.ndarray  # int32[M] the endpoints this plan was built for
    dst: np.ndarray  # int32[M]

    def tensors(self, device) -> tuple:
        """The plan as `_solve_mcmf`'s ten plan arguments on `device`."""
        return tuple(
            torch.as_tensor(x, device=device)
            for x in (
                self.s_arc, self.s_sign, self.s_src, self.s_dst,
                self.s_segstart, self.s_isstart, self.inv_order,
                self.node_first, self.node_last, self.node_nonempty,
            )
        )


def build_csr_plan(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> CsrPlan:
    m = len(src)
    esrc = np.concatenate([src, dst])
    order = np.argsort(esrc, kind="stable").astype(np.int32)
    s_src = esrc[order]
    s_dst = np.concatenate([dst, src])[order]
    s_arc = np.where(order < m, order, order - m).astype(np.int32)
    s_sign = np.where(order < m, 1, -1).astype(np.int32)
    inv_order = np.empty(2 * m, dtype=np.int32)
    inv_order[order] = np.arange(2 * m, dtype=np.int32)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    counts = np.bincount(s_src, minlength=num_nodes)
    row_ptr[1:] = np.cumsum(counts)
    s_segstart = row_ptr[s_src].astype(np.int32)
    s_isstart = np.zeros(2 * m, dtype=bool)
    s_isstart[np.unique(s_segstart)] = True
    node_first = np.minimum(row_ptr[:-1], 2 * m - 1).astype(np.int32)
    node_last = np.maximum(row_ptr[1:] - 1, 0).astype(np.int32)
    node_nonempty = row_ptr[1:] > row_ptr[:-1]
    return CsrPlan(
        s_arc=s_arc,
        s_sign=s_sign,
        s_src=s_src.astype(np.int32),
        s_dst=s_dst.astype(np.int32),
        s_segstart=s_segstart,
        s_isstart=s_isstart,
        inv_order=inv_order,
        node_first=node_first,
        node_last=node_last,
        node_nonempty=node_nonempty,
        src=src.copy(),
        dst=dst.copy(),
    )


def _seg_sum(vals, node_first, node_last, node_nonempty):
    """Per-node sum over a sorted-entry array: cumsum + boundary gathers
    (int32, wrapping like the JAX package's)."""
    c = torch.cumsum(vals, 0, dtype=_I32)
    excl_first = c[node_first] - vals[node_first]
    seg = c[node_last] - excl_first
    return torch.where(node_nonempty, seg, 0)


def _seg_reduce(vals, isstart, node_last, node_nonempty, identity, how):
    """Per-node max ("amax") or min ("amin") over the segments that
    `isstart` opens: each node's value is the reduction over its own
    entries (what the JAX package's segmented scan holds at node_last),
    `identity` for a node without entries."""
    seg = torch.cumsum(isstart, 0) - 1
    per_seg = torch.full_like(vals, identity).scatter_reduce_(
        0, seg, vals, how, include_self=False)
    return torch.where(node_nonempty, per_seg[seg[node_last]], identity)


def _seg_max(vals, isstart, node_last, node_nonempty, identity):
    return _seg_reduce(vals, isstart, node_last, node_nonempty, identity, "amax")


def _seg_min(vals, isstart, node_last, node_nonempty, identity):
    return _seg_reduce(vals, isstart, node_last, node_nonempty, identity, "amin")


def _solve_mcmf(
    cap, cost, supply, flow0, eps_init,
    s_arc, s_sign, s_src, s_dst, s_segstart, s_isstart, inv_order,
    node_first, node_last, node_nonempty,
    warm_p=None,
    alpha: int = 8,
    max_supersteps: int = 50_000,
    tighten_sweeps: int = 32,
    telemetry_cap: int = 0,
    use_warm_p: bool = False,
    slot_stable: bool = False,
):
    """One scan-CSR solve: (flow int32[M], p int32[N], steps int32,
    converged bool, p_overflow bool) tensors on cap's device, equal to
    ksched_tpu's `_solve_mcmf` bit for bit.

    cap/cost/flow0 are int32[M] per arc (cost pre-scaled by the node
    count), supply int32[N], eps_init an int or int32 scalar; the plan
    tensors are a CsrPlan's, or with slot_stable=True a SlotPlanState's
    (graph/slot_plan.py): entry rows in fixed per-node regions with
    slack, a dead row marked by sign 0 and given residual 0, so it is
    inert in every reduction. use_warm_p=True refits the carried
    potentials `warm_p` (the Bellman sweeps seeded with d0 = -warm_p)
    instead of tightening from scratch. Each host read of a flag or a
    scalar adds one to `_solve_mcmf.reads`.

    telemetry_cap > 0 appends the int32 [telemetry_cap, SOLTEL_WIDTH]
    soltel ring (obs/soltel.py) to the returned tuple, a row written on
    the device at `step % cap` for every superstep; its counters read
    values each superstep already computes, so flows are bit-identical
    with the ring on or off."""
    from ..obs import soltel

    m = cap.shape[0]
    s_arc, s_src, s_dst, s_segstart, inv_order, node_first, node_last = (
        t.long() for t in (s_arc, s_src, s_dst, s_segstart, inv_order,
                           node_first, node_last))
    s_sign = s_sign.to(_I32)
    s_isstart = s_isstart.to(torch.bool)
    node_nonempty = node_nonempty.to(torch.bool)
    s_cap = cap[s_arc]
    s_cost = s_sign * cost[s_arc]
    fwd_pos = inv_order[:m]
    cap_src = s_src[fwd_pos]
    cap_dst = s_dst[fwd_pos]

    def residual(a_flow):
        if slot_stable:
            return torch.where(s_sign > 0, s_cap - a_flow,
                               torch.where(s_sign < 0, a_flow, 0))
        return torch.where(s_sign > 0, s_cap - a_flow, a_flow)

    def excess_of(flow):
        return supply - _seg_sum(s_sign * flow[s_arc], node_first, node_last,
                                 node_nonempty)

    def saturate(flow, p):
        """Refine step: saturate every residual entry with negative
        reduced cost, making the pseudoflow 0-optimal for the phase."""
        rc_fwd = cost + p[cap_src] - p[cap_dst]
        return torch.where(rc_fwd < 0, cap, torch.where(rc_fwd > 0, 0, flow))

    def tighten(flow, d0=None):
        """Price tightening: p = -(shortest residual-cost distance to a
        demand node) by synchronous Bellman-Ford sweeps over the sorted
        entries; seeded with an explicit d0 it is the warm refit."""
        r = residual(flow[s_arc])
        if d0 is None:
            d0 = torch.where(excess_of(flow) < 0, 0, _BIG_D).to(_I32)
        d, changed, it = d0, True, 0
        while changed and it < tighten_sweeps:
            cand = torch.where(r > 0, s_cost + d[s_dst], _BIG_D)
            best = _seg_min(cand, s_isstart, node_last, node_nonempty, _BIG_D)
            d2 = torch.clamp(torch.minimum(d, best), min=-_BIG_D)
            changed = bool((d2 != d).any())
            _solve_mcmf.reads += 1
            d, it = d2, it + 1
        return -torch.clamp(d, max=_BIG_D)

    def superstep(flow, p, eps, excess):
        r = residual(flow[s_arc])
        rc = s_cost + p[s_src] - p[s_dst]
        e_at = excess[s_src]
        admissible = (r > 0) & (rc < 0) & (e_at > 0)
        # maximal push: allocate each node's excess across its admissible
        # entries front to back by an in-segment exclusive prefix sum
        r_adm = torch.where(admissible, r, 0)
        excl = torch.cumsum(r_adm, 0, dtype=_I32) - r_adm
        prefix_before = excl - excl[s_segstart]
        delta = torch.minimum(torch.clamp(e_at - prefix_before, min=0), r_adm)
        delta_orig = delta[inv_order]
        new_flow = flow + delta_orig[:m] - delta_orig[m:]
        # relabel the nodes that were active but pushed nothing
        pushed = _seg_sum(delta, node_first, node_last, node_nonempty)
        sum_r = _seg_sum(r, node_first, node_last, node_nonempty)
        cand = torch.where(r > 0, p[s_dst] - s_cost, -_BIG)
        best = _seg_max(cand, s_isstart, node_last, node_nonempty, -_BIG)
        relabel = (excess > 0) & (pushed == 0) & (sum_r > 0)
        new_p = torch.where(relabel, best - eps, p)
        if not telemetry_cap:
            return new_flow, new_p, ()
        # soltel cols 3..6: pushed units, relabels, saturated forward
        # entries (before the push) and admissible entries
        aux = (
            torch.sum(pushed, dtype=_I32),
            torch.sum(relabel, dtype=_I32),
            torch.sum((s_sign > 0) & (r == 0), dtype=_I32),
            torch.sum(r_adm > 0, dtype=_I32),
        )
        return new_flow, new_p, aux

    dev = cap.device
    tel = soltel.device_ring(telemetry_cap, dev) if telemetry_cap else None
    if use_warm_p:
        p = tighten(flow0, d0=torch.clamp(-warm_p, -_BIG_D, _BIG_D))
    else:
        p = tighten(flow0)
    flow = saturate(flow0, p)  # mop up any residual violations
    eps, steps, done = int(eps_init), 0, False
    while not done and steps < max_supersteps:
        excess = excess_of(flow)
        _solve_mcmf.reads += 1
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
    converged = done and int(excess_of(flow).abs().max()) == 0
    p_overflow = int(p.abs().max()) >= _P_GUARD
    _solve_mcmf.reads += 1 + done
    out = (
        flow, p, torch.tensor(steps, dtype=_I32, device=dev),
        torch.tensor(converged, device=dev), torch.tensor(p_overflow, device=dev),
    )
    return out + (tel,) if telemetry_cap else out


#: host reads (flags and scalars) of every solve since it was set to 0
_solve_mcmf.reads = 0


class CsrSolver(FlowSolver):
    """Cost-scaling push-relabel over the scan-CSR layout, warm-started
    across rounds: ksched_tpu's JaxSolver.

    The warm policy is JaxSolver's. The previous round's flow is carried
    on arcs whose endpoints are unchanged since the last successful
    solve; with ``journal_scoped_warm`` (default) it is carried only
    when no arc was re-wired (plan_key equal to the last solve's; a
    problem without a key compares the endpoint arrays), since
    discharging displaced flow is a unit-relabel price war. Carried
    potentials are refitted (``warm_potentials``). Attempt 1 runs at
    eps 1 within min(4096, max_supersteps) supersteps
    (``restart_budget`` caps a kept-flow attempt and escapes to a fresh
    restart); the last resort is a cold cost-scaling solve from
    max|cost|·n.

    A problem that carries a maintained slot-stable plan (every
    DeviceGraphState problem) is solved on it: the device-resident
    mirror's plan tensors when present, else the plan's own cached
    upload. Plain array problems keep the host-built CsrPlan. A device-resident problem is solved on its
    persistent tensors, and the flow, its potentials and the endpoint
    tensors of the last successful solve stay on the card between
    rounds. Tensors live on ``device`` ("cuda" by default; it raises
    where there is no card)."""

    def __init__(self, alpha: int = 8, max_supersteps: int = 50_000,
                 warm_start: bool = True, warm_potentials: bool = True,
                 restart_budget: Optional[int] = None,
                 journal_scoped_warm: bool = True, telemetry: Optional[int] = None,
                 device="cuda"):
        from ..utils.device import resolve_device
        from .layered import validate_alpha

        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.warm_start = warm_start
        self.warm_potentials = warm_potentials
        self.journal_scoped_warm = journal_scoped_warm
        self.restart_budget = restart_budget
        #: soltel ring capacity; None = obs/soltel.resolve_cap's default
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._prev: Optional[np.ndarray] = None  # previous round's flow
        self._prev_dev: Optional[torch.Tensor] = None  # same, resident rounds
        self._prev_p: Optional[torch.Tensor] = None  # and its potentials
        #: endpoints at the LAST SUCCESSFUL SOLVE (the warm mask): the
        #: mirror's tensors on resident rounds, host arrays otherwise
        self._prev_src_dev: Optional[torch.Tensor] = None
        self._prev_dst_dev: Optional[torch.Tensor] = None
        self._prev_src_host: Optional[np.ndarray] = None
        self._prev_dst_host: Optional[np.ndarray] = None
        self._plan: Optional[CsrPlan] = None
        self._plan_dev: Optional[tuple] = None
        self._plan_key = None
        #: endpoint key at the last successful solve
        self._key_solved = None
        self.last_supersteps = 0
        #: SolveTelemetry of the last solve's final attempt (or None)
        self.last_telemetry = None
        self.last_warm_scope = "cold"  # warm | fresh | cold
        #: host reads of the last solve's attempts (`_solve_mcmf.reads`)
        self.last_host_reads = 0
        #: bytes the last solve copied host -> device: the problem's
        #: arrays and warm flow, and the plan tensors it (re)uploaded
        #: (0 on a device-resident problem, whose mirror counts its own)
        self.last_upload_bytes = 0

    def reset(self) -> None:
        self._prev = None
        self._prev_dev = None
        self._prev_p = None
        self._prev_src_dev = None
        self._prev_dst_dev = None
        self._prev_src_host = None
        self._prev_dst_host = None
        self._key_solved = None

    # -- warm-state checkpointing (runtime/checkpoint.save_warm_manifest) --

    def export_warm_state(self) -> Optional[dict]:
        """The carried warm state as host arrays, or None when cold —
        what a warm crash restore needs to make its first solve
        bit-identical to the never-killed process's. One device-to-host
        copy of the potentials (the flow already has a host copy)."""
        if self._prev is None:
            return None

        def host(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                a = a.cpu().numpy()
            return np.asarray(a, np.int32)

        return {
            "prev": host(self._prev),
            "prev_p": host(self._prev_p),
            "prev_src": host(self._prev_src_host),
            "prev_dst": host(self._prev_dst_host),
            "key_solved": self._key_solved,
        }

    def import_warm_state(self, state: dict, key_solved=None,
                          resident: bool = False) -> None:
        """Adopt an export_warm_state payload. `key_solved` is the
        endpoint key REMAPPED onto the restored DeviceGraphState (its
        uid changes across processes; the checkpoint loader owns the
        remap). The potentials go to the solver's device; with
        `resident`, so do the warm flow and the last-solve endpoint
        masks, so a device-resident loop's first post-restore warm
        attempt consumes the exact values the killed process carried."""
        def host(name):
            a = state.get(name)
            return None if a is None else np.asarray(a, np.int32)

        def dev(a):
            return None if a is None else torch.tensor(a, device=self.device)

        self._prev = host("prev")
        self._prev_p = dev(host("prev_p"))
        self._prev_src_host = host("prev_src")
        self._prev_dst_host = host("prev_dst")
        self._key_solved = key_solved if key_solved is not None else state.get("key_solved")
        if resident and self._prev_src_host is not None:
            self._prev_dev = dev(self._prev)
            self._prev_src_dev = dev(self._prev_src_host)
            self._prev_dst_dev = dev(self._prev_dst_host)
        else:
            self._prev_dev = None
            self._prev_src_dev = None
            self._prev_dst_dev = None

    def _plan_for(self, src, dst, n, plan_key=None) -> tuple:
        plan = self._plan
        if plan_key is not None and self._plan_key == plan_key and plan is not None:
            return self._plan_dev  # generation key match: no scans at all
        if plan is None or len(plan.src) != len(src) or len(plan.node_first) != n or plan_key is not None or not (
            np.array_equal(plan.src, src) and np.array_equal(plan.dst, dst)
        ):
            plan = build_csr_plan(src, dst, n)
            self._plan = plan
            self._plan_dev = plan.tensors(self.device)
            self.last_upload_bytes += sum(t.nbytes for t in self._plan_dev)
        self._plan_key = plan_key
        return self._plan_dev

    def _attempt(self, args, flow0, eps, budget, slot_stable, tel_cap, warm_p=None):
        """One `_solve_mcmf` attempt: (flow, p, steps, converged,
        p_overflow, ring or None)."""
        out = _solve_mcmf(
            *args[:3], flow0, eps, *args[3:], warm_p=warm_p,
            use_warm_p=warm_p is not None, alpha=self.alpha,
            max_supersteps=budget, telemetry_cap=tel_cap, slot_stable=slot_stable,
        )
        return out if tel_cap else out + (None,)

    def solve_async(self, problem: FlowProblem):
        """Run the warm attempt; complete() escalates if it failed."""
        self.last_upload_bytes = 0
        n = problem.num_nodes
        m = len(problem.src)
        if m == 0 or problem.num_arcs == 0:
            if (problem.excess > 0).any():
                raise RuntimeError("infeasible flow problem: supply but no arcs")
            return (problem, None, None)
        check_finite_costs(problem)
        src = np.asarray(problem.src, np.int32)
        dst = np.asarray(problem.dst, np.int32)
        max_cost = int(np.abs(problem.cost).max()) if m else 0
        if max_cost * n >= (1 << 30):
            raise OverflowError(
                f"scaled costs overflow int32: max|cost|={max_cost} at {n} nodes; "
                "rescale cost-model outputs or shrink the graph padding"
            )
        resident = getattr(problem, "d_cap", None) is not None
        plan_state = getattr(problem, "plan", None)
        slot_stable = plan_state is not None
        if slot_stable:
            # endpoint churn is already folded into the maintained
            # layout: the resident mirror's tensors, else the plan's own
            # upload (re-shipped only when its value_version moved)
            d_plan = getattr(problem, "d_plan", None)
            if d_plan is not None:
                plan_dev = d_plan
            else:
                before = plan_state.uploaded_bytes
                plan_dev = plan_state.device_args(self.device)
                self.last_upload_bytes += plan_state.uploaded_bytes - before
        else:
            plan_dev = self._plan_for(src, dst, n,
                                      plan_key=getattr(problem, "plan_key", None))
        plan_key = getattr(problem, "plan_key", None)
        keep_flow = True
        if self.journal_scoped_warm and plan_key is not None:
            keep_flow = self._key_solved is not None and plan_key == self._key_solved
        dev = self.device
        if resident:
            from ..graph.device_export import resident_solver_inputs

            dev_args, flow0_dev, warm = resident_solver_inputs(
                problem, self._prev_dev, self._prev_src_dev,
                self._prev_dst_dev, self.warm_start and keep_flow, self.device,
            )
        else:
            cap = problem.cap.astype(np.int32)
            supply = problem.excess.astype(np.int32)
            cost = problem.cost.astype(np.int32) * np.int32(n)
            dev_args = tuple(torch.as_tensor(x, device=dev) for x in (cap, cost, supply))
            warm = (
                self.warm_start
                and keep_flow
                and self._prev is not None
                and len(self._prev) == m
                and self._prev_src_host is not None
                and len(self._prev_src_host) == m
            )
            flow0 = np.zeros(m, dtype=np.int32)
            if warm:
                same = (self._prev_src_host == src) & (self._prev_dst_host == dst)
                if self.journal_scoped_warm and plan_key is None and not same.all():
                    warm = False
                else:
                    flow0 = np.where(same, np.minimum(self._prev, cap), 0).astype(np.int32)
            flow0_dev = torch.as_tensor(flow0, device=dev)
            self.last_upload_bytes += sum(x.nbytes for x in (cap, cost, supply, flow0))
        had_state = self._prev is not None or self._prev_dev is not None
        self.last_warm_scope = "warm" if warm else ("fresh" if had_state else "cold")
        args = tuple(dev_args) + tuple(plan_dev)
        warm_p_ok = (
            self.warm_potentials
            and warm
            and self._prev_p is not None
            and self._prev_p.shape[0] == n
        )
        budget = min(4096, self.max_supersteps)
        if warm and self.restart_budget is not None:
            budget = min(budget, self.restart_budget)
        from ..obs import soltel

        tel_cap = soltel.resolve_cap(self.telemetry)
        reads0 = _solve_mcmf.reads
        out = self._attempt(args, flow0_dev, 1, budget, slot_stable, tel_cap,
                            self._prev_p if warm_p_ok else None)
        cold = max(1, max_cost * n)
        return (problem, out, (args, cold, warm, slot_stable, resident, reads0,
                               tel_cap, budget))

    def complete(self, pending) -> FlowResult:
        from ..obs import soltel

        problem, out, rest = pending
        if out is None:
            self.last_telemetry = None
            return FlowResult(flow=np.zeros(len(problem.src), dtype=np.int64),
                              objective=0, iterations=0)
        args, eps_cold, warm, slot_stable, resident, reads0, tel_cap, budget1 = rest
        m = len(problem.src)
        zeros = torch.zeros(m, dtype=_I32, device=args[0].device)

        def decode(tel_buf, steps, budget, converged):
            if tel_buf is None:
                return None
            return soltel.decode(tel_buf, steps, tel_cap, "jax", budget,
                                 converged=converged, nodes=problem.num_nodes,
                                 arcs=m)

        flow, p, steps, converged, p_overflow, tel_buf = out
        spent = int(steps)
        ok = bool(converged) and not bool(p_overflow)
        if warm and not ok and not bool(converged):
            # a warm attempt that burned its budget is a price war, not a
            # hard instance: a structured event for the flight recorder
            # (a converged attempt that tripped the overflow guard is not)
            soltel.warm_price_war(
                "jax", supersteps=int(steps), budget=budget1,
                escaped_to=("fresh_restart" if self.restart_budget is not None
                            else "cost_scaling"),
                tel=decode(tel_buf, int(steps), budget1, False),
            )
        if warm and not ok and self.restart_budget is not None:
            # restart escape: a warm attempt that blew its budget
            # re-solves fresh (zero flow, tightened prices, eps 1)
            flow, p, steps, converged, p_overflow, tel_buf = self._attempt(
                args, zeros, 1, min(4096, self.max_supersteps), slot_stable, tel_cap)
            spent += int(steps)
            ok = bool(converged) and not bool(p_overflow)
        if not ok:
            flow, p, steps, converged, p_overflow, tel_buf = self._attempt(
                args, zeros, eps_cold, self.max_supersteps, slot_stable, tel_cap)
            spent += int(steps)
        # every attempt's supersteps: the work this round, not the winner's
        self.last_supersteps = spent
        self.last_host_reads = _solve_mcmf.reads - reads0
        # the ring is the final attempt's; its budget is the solver's
        self.last_telemetry = decode(tel_buf, int(steps), self.max_supersteps,
                                     bool(converged) and not bool(p_overflow))
        if bool(p_overflow) or not bool(converged):
            self.reset()  # never reuse the state that failed
        if bool(p_overflow):
            raise OverflowError("push-relabel potentials approached int32 range")
        if not bool(converged):
            tel = self.last_telemetry
            raise SolverStallError(
                f"push-relabel did not converge within {self.max_supersteps} supersteps; "
                "the flow problem may be infeasible (missing unscheduled-aggregator arcs?)",
                reason=soltel.detect_stall(tel) if tel is not None else None,
                telemetry=tel,
            )
        flow_np = flow.cpu().numpy()
        if self.warm_start:
            self._prev = flow_np.astype(np.int32)
            # on resident rounds the flow and the endpoint tensors of
            # this solve stay on the card for the next warm mask
            self._prev_dev = flow if resident else None
            self._prev_src_dev = problem.d_src if resident else None
            self._prev_dst_dev = problem.d_dst if resident else None
            self._prev_src_host = np.asarray(problem.src, np.int32)
            self._prev_dst_host = np.asarray(problem.dst, np.int32)
            self._key_solved = getattr(problem, "plan_key", None)
            self._prev_p = p
        objective = int(
            (flow_np.astype(np.int64) * problem.cost.astype(np.int64)).sum()
        ) + lower_bound_cost(problem)
        return FlowResult(flow=flow_np.astype(np.int64), objective=objective,
                          iterations=spent)

    def solve(self, problem: FlowProblem) -> FlowResult:
        return self.complete(self.solve_async(problem))
