"""Dense layered MCMF: the transport fast path for the aggregate topology.

The quincy-style scheduling graph (reference: trivial_cost_modeler.go:
101-110 + graph_manager.go:931-1010) is layered and aggregate:

    task --(u)--> unsched[job] --> sink
    task --(e)--> EC[class]
    EC[c] --(cost[c,m], cap free_m)--> machine_m --> PU --> sink

Tasks of one class are interchangeable, the PU layer never binds
tighter than its machine, and the per-job unscheduled aggregators always
have enough escape capacity. So the min-cost flow collapses EXACTLY to a
transportation problem over a dense [C, M+1] matrix:

    minimize    sum_{c,m} y[c,m] * w[c,m]
    subject to  sum_m y[c,m] == supply[c]          (every task routed)
                sum_c y[c,m] <= col_cap[m]         (machine free slots)

with w[c,m] = cost[c,m] + e - u for real machines and w[c,M] = 0 for the
"unscheduled" column (cap = total supply, so the problem is always
feasible — the unscheduled-aggregator invariant, graph_manager.go:
1270-1305).

The solve is synchronous Goldberg-Tarjan cost-scaling push-relabel
(costs pre-scaled so eps=1 is exact; maximal pushes via in-row exclusive
prefix sums; jump relabels) after a Bellman-Ford price-tightening
prelude which is EXACT here (the residual graph of the zero flow has
diameter 2). Integer arithmetic only, in int32 throughout.

This module holds the plain PyTorch version of that solve
(`_solve_transport` and its parts) beside the host harness. On the card
the whole solve runs in one CUDA kernel (ops/transport.py), which
reproduces this plain version bit for bit; `ops.transport_solve` picks
by the device of the tensors it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.build import KernelError

#: sentinel magnitudes; the CUDA kernel (ops/csrc/transport.cu) uses
#: the same values, and bit parity depends on matching fills
BIG = 1 << 30
BIG_D = 1 << 28

_I32 = torch.int32


def validate_job_unsched_cost(job_unsched_cost, num_jobs: int):
    """Normalize/validate the per-job unsched-cost knob (None passes
    through)."""
    if job_unsched_cost is None:
        return None
    out = np.asarray(job_unsched_cost, np.int64)
    if out.shape != (num_jobs,):
        raise ValueError(
            f"job_unsched_cost must have shape ({num_jobs},), got {out.shape}"
        )
    # Values at or beyond COST_SCALE_LIMIT are guaranteed to overflow
    # once scaled, and would wrap silently after an int32 cast.
    if out.size and int(np.abs(out).max()) >= COST_SCALE_LIMIT:
        raise OverflowError(
            f"job_unsched_cost magnitude {int(np.abs(out).max())} exceeds "
            f"the scaled-cost limit {COST_SCALE_LIMIT}"
        )
    return out


def validate_alpha(alpha: int) -> int:
    """alpha < 2 would make the eps phase schedule a fixed point and
    hang the solve loop; one guard shared by every constructor that
    accepts the knob."""
    if alpha < 2:
        raise ValueError(f"alpha must be >= 2 (got {alpha}): the eps "
                         "phase schedule would never shrink")
    return int(alpha)


@dataclass
class LayeredProblem:
    """The aggregate scheduling round, in row-by-machine form. A row is
    a commodity of interchangeable tasks: a task class in the basic
    shape, or a (job, class) group when per-job unscheduled costs
    differentiate jobs (graph_manager.go:1291-1305)."""

    supply: np.ndarray  # int32[C] unplaced live tasks per row
    col_cap: np.ndarray  # int32[M] free slots per machine
    cost_cm: np.ndarray  # int32[C, M] EC->machine arc cost per row
    unsched_cost: int  # u: task->unsched arc cost
    ec_cost: int  # e: task->EC arc cost
    #: optional per-row unsched costs overriding the scalar (int[C]);
    #: row r's escape then costs row_unsched_cost[r]
    row_unsched_cost: Optional[np.ndarray] = None


@dataclass
class LayeredResult:
    y: np.ndarray  # int64[C, M] tasks of class c placed on machine m
    num_unsched: int
    objective: int  # in full-graph units: u*unplaced + sum((e+cost)*y)
    supersteps: int


def pad_geometry(num_machines: int, num_classes: int) -> Tuple[int, int]:
    """(Mp, n_scale) for the padded transport problem.

    Mp pads the machine axis to a multiple of 128 with room for the
    unsched column; n_scale is the cost multiplier that makes eps=1
    termination exact: smallest pow2 > the REAL node count
    C + (M+1) + 1 (rows + live columns + sink). Padded columns have no
    arcs (cap 0), so the exactness bound is independent of Mp."""
    Mp = ((num_machines + 1 + 127) // 128) * 128
    n_scale = 1
    while n_scale < num_classes + num_machines + 3:
        n_scale <<= 1
    return Mp, n_scale


#: scaled costs must stay below 2^29 for int32 arithmetic headroom:
#: with |wS| < 2^29 and pm clamped to ±2^28 (transport_tighten), the
#: derived row prices satisfy |pr| <= 2^28 + 2^29, so any reduced cost
#: rcf = wS + pr - pm is bounded by 2^29 + (2^28 + 2^29) + 2^28 =
#: 1.5 * 2^30 < 2^31 - 1, wrap-free.
COST_SCALE_LIMIT = 1 << 29


def default_eps0(n_scale: int) -> int:
    """The tuned eps-schedule start for iterative transport solves:
    n_scale/4 — a quarter of one original cost unit. Valid for any
    value (tightened potentials make the zero flow 0-optimal
    regardless); callers keep a full-range fallback. Only right for
    instances that are NOT oversubscribed — use choose_eps0 where
    supply and capacity are at hand."""
    return max(1, n_scale // 4)


def choose_eps0(n_scale: int, eps_full, supply_total, real_cap_total,
                short=None):
    """Adaptive eps-schedule start: the tuned short start when supply
    fits real machine capacity, the classic full-range start when the
    instance is oversubscribed. `short` overrides the default_eps0
    start (the tiered preemption round passes n_scale). Python ints in,
    a Python int out; any tensor input gives an int32 tensor, computed
    on the device without a host read."""
    if short is None:
        short = default_eps0(n_scale)
    if not any(isinstance(v, torch.Tensor)
               for v in (eps_full, supply_total, real_cap_total)):
        return eps_full if supply_total > real_cap_total else short
    dev = next(v for v in (eps_full, supply_total, real_cap_total)
               if isinstance(v, torch.Tensor)).device

    def t(v):
        if isinstance(v, torch.Tensor):
            return v.to(_I32)
        return torch.full((), v, dtype=_I32, device=dev)

    return torch.where(t(supply_total) > t(real_cap_total), t(eps_full), t(short))


def solve_row_constant_np(v, supply, col_cap):
    """EXACT closed form when every row's cost is machine-uniform:
    w[g, m] = v[g] for all real columns m. The objective is linear in
    per-row placement totals, so the optimum is the fractional-knapsack
    greedy: rows in ascending v, rows with v >= 0 place nothing, the
    machine split assigned in (row-order, machine-order) interval
    overlaps. v int32[G]; supply int32[G]; col_cap int32[Mp1] (last =
    escape). Returns y int64[G, Mp1] with the escape column filled."""
    cap_real = col_cap[:-1].astype(np.int64)
    cap_total = int(cap_real.sum())
    order = np.argsort(v, kind="stable")
    sup_s = supply[order].astype(np.int64)
    take_s = np.where(v[order] < 0, sup_s, 0)
    excl = np.cumsum(take_s) - take_s
    q_s = np.clip(cap_total - excl, 0, take_s)
    Q = np.cumsum(q_s)
    starts = Q - q_s
    cum_m = np.cumsum(cap_real)
    lo = np.maximum((cum_m - cap_real)[None, :], starts[:, None])
    hi = np.minimum(cum_m[None, :], Q[:, None])
    y_s = np.maximum(hi - lo, 0)
    y_real = np.empty_like(y_s)
    y_real[order] = y_s
    esc = supply.astype(np.int64) - y_real.sum(axis=1)
    return np.concatenate([y_real, esc[:, None]], axis=1)


def solve_single_class_np(w: np.ndarray, supply: int, col_cap: np.ndarray) -> np.ndarray:
    """EXACT closed form for one transportation row: sort columns by
    cost and greedily fill strictly-profitable capacity (ties at w == 0
    are objective-neutral and left unscheduled)."""
    take = np.where(w < 0, col_cap, 0).astype(np.int64)
    order = np.argsort(w, kind="stable")
    take_s = take[order]
    excl = np.cumsum(take_s) - take_s
    y_s = np.clip(supply - excl, 0, take_s)
    y = np.empty_like(y_s)
    y[order] = y_s
    return y


def split_grants_by_class(y_tot, supply):
    """Split single-class machine grants y_tot[Mp] among C classes with
    per-class supplies [C] — any split is cost-equal when every class
    has the same cost row, so grant units are handed out in
    (machine-order, class-order): y[c,m] = overlap of the class's supply
    interval with the machine's grant interval. numpy arrays or int32
    tensors in, the same kind out."""
    if isinstance(y_tot, torch.Tensor):
        cum_s = torch.cumsum(supply, 0, dtype=_I32)
        excl_s = (cum_s - supply)[:, None]
        cum_m = torch.cumsum(y_tot, 0, dtype=_I32)[None, :]
        lo = torch.maximum(cum_m - y_tot[None, :], excl_s)
        hi = torch.minimum(cum_m, excl_s + supply[:, None])
        return torch.clamp(hi - lo, min=0).to(y_tot.dtype)
    cum_s = np.cumsum(supply)
    excl_s = (cum_s - supply)[:, None]  # [C, 1] class interval starts
    cum_m = np.cumsum(y_tot)[None, :]  # [1, Mp] machine interval ends
    lo = np.maximum(cum_m - y_tot[None, :], excl_s)
    hi = np.minimum(cum_m, excl_s + supply[:, None])
    return np.maximum(hi - lo, 0).astype(y_tot.dtype)


# ---------------------------------------------------------------------------
# Closed forms on tensors (the device round's non-iterative solves)
# ---------------------------------------------------------------------------


def _argsort(x):
    return torch.sort(x, stable=True).indices


def _unsort(order, values):
    """values[i] belongs at position order[i]: the inverse permutation
    applied by a scatter."""
    return torch.empty_like(values).scatter_(0, order, values)


def solve_single_class(w, supply, col_cap):
    """EXACT closed form for one transportation row: sort columns by
    cost and greedily fill strictly-profitable capacity; ties at
    w == 0 are left unscheduled. w, col_cap int32[Mp1], supply an int32
    scalar tensor; returns y int32[Mp1]."""
    take = torch.where(w < 0, col_cap, 0)
    order = _argsort(w)
    take_s = take[order]
    excl = torch.cumsum(take_s, 0, dtype=_I32) - take_s
    y_s = torch.minimum(torch.clamp(supply - excl, min=0), take_s)
    return _unsort(order, y_s)


def solve_single_class_tiered(wLo, wHi, R, supply, col_cap):
    """EXACT closed form for one tiered row: each column is a cheap tier
    (cap min(R, col_cap), cost wLo) and a base tier (the rest at wHi);
    greedy-fill strictly-profitable capacity by sorted marginal cost —
    valid because the per-cell cost is convex. Returns y int32[Mp1]
    (tier totals per column)."""
    Mp1 = wLo.shape[0]
    Reff = torch.minimum(R, col_cap)
    w2 = torch.cat([wLo, wHi])
    cap2 = torch.cat([Reff, col_cap - Reff])
    y2 = solve_single_class(w2, supply, cap2)
    return y2[:Mp1] + y2[Mp1:]


def solve_row_constant(v, supply, col_cap):
    """EXACT closed form when every row's cost is machine-uniform:
    w[g, m] = v[g] on every real column (per-job unsched costs, no class
    cost model). The fractional-knapsack greedy: rows in ascending v,
    rows with v >= 0 place nothing, the machine split in (row-order,
    machine-order) interval overlaps. v, supply int32[G]; col_cap
    int32[Mp1] (last = escape). Returns y int32[G, Mp1] with the escape
    column filled."""
    cap_real = col_cap[:-1]
    cap_total = cap_real.sum(dtype=_I32)
    order = _argsort(v)
    sup_s = supply[order]
    take_s = torch.where(v[order] < 0, sup_s, 0)
    excl = torch.cumsum(take_s, 0, dtype=_I32) - take_s
    q_s = torch.minimum(torch.clamp(cap_total - excl, min=0), take_s)
    Q = torch.cumsum(q_s, 0, dtype=_I32)
    starts = Q - q_s
    cum_m = torch.cumsum(cap_real, 0, dtype=_I32)
    lo = torch.maximum((cum_m - cap_real)[None, :], starts[:, None])
    hi = torch.minimum(cum_m[None, :], Q[:, None])
    y_s = torch.clamp(hi - lo, min=0)
    y_real = torch.empty_like(y_s).index_copy_(0, order, y_s)
    esc = supply - y_real.sum(dim=1, dtype=_I32)
    return torch.cat([y_real, esc[:, None]], dim=1)


# ---------------------------------------------------------------------------
# The plain version of the transport kernel
# ---------------------------------------------------------------------------


def _excesses(supply, y, z):
    e_row = supply - y.sum(dim=1, dtype=_I32)
    e_col = y.sum(dim=0, dtype=_I32) - z
    e_sink = z.sum(dtype=_I32) - supply.sum(dtype=_I32)
    return e_row, e_col, e_sink


def transport_tighten(wS, U, col_cap, pm0=None):
    """Potentials making the ZERO flow 0-optimal, from optional carried
    machine prices pm0 (warm start across rounds).

    pm = pm0 on live columns (cap>0), sunk to -BIG_D for dead ones; row
    prices are re-derived as pr[c] = max_{U>0}(pm - wS) (0 for a row
    with no arc) so every forward residual arc has reduced cost >= 0,
    and psink = min_{cap>0} pm likewise. pm0 is clamped to ±BIG_D so a
    price vector carried over many rounds cannot drift until pm0 - wS
    wraps int32. With pm0 = None/zeros this is the cold start."""
    if pm0 is None:
        pm0 = torch.zeros_like(col_cap)
    live = col_cap > 0
    pm = torch.where(live, pm0.clamp(-BIG_D, BIG_D), -BIG_D)
    has_arc = U > 0
    pr = torch.where(has_arc, pm[None, :] - wS, -BIG_D).amax(dim=1)
    pr = torch.where(has_arc.any(dim=1), pr, 0)
    psink = torch.where(live, pm, BIG_D).amin()
    psink = torch.where(live.any(), psink, 0)
    return pr, pm, psink


def transport_saturate(wS, U, col_cap, y, z, pr, pm, psink):
    rcf = wS + pr[:, None] - pm[None, :]
    y2 = torch.where(rcf < 0, U, torch.where(rcf > 0, 0, y))
    rcs = pm - psink
    z2 = torch.where(rcs < 0, col_cap, torch.where(rcs > 0, 0, z))
    return y2, z2


def transport_saturate_eps(wS, U, col_cap, y, z, pr, pm, psink, eps: int):
    """Partial saturate: reset ONLY the arcs violating eps-optimality,
    keeping the rest of the flow (used after price refinement). With
    eps=0 this is transport_saturate."""
    rcf = wS + pr[:, None] - pm[None, :]
    y2 = torch.where(rcf < -eps, U, torch.where(rcf > eps, 0, y))
    rcs = pm - psink
    z2 = torch.where(rcs < -eps, col_cap, torch.where(rcs > eps, 0, z))
    return y2, z2


def _price_refine(wS, U, col_cap, y, z, pr, pm, psink, eps: int, waves: int):
    """Price refinement: `waves` synchronous Bellman-Ford relaxations
    that LOWER potentials toward eps-optimality of the CURRENT flow
    before the next phase. Whatever violations remain are cleaned by
    transport_saturate_eps, so optimality never depends on the refit
    finishing."""
    for _ in range(waves):
        # fwd residual row->col (U-y>0): pm <= wS + pr + eps
        bound_m = torch.where(U - y > 0, wS + pr[:, None] + eps, BIG).amin(dim=0)
        pm2 = torch.clamp(torch.minimum(pm, bound_m), min=-BIG_D)
        # sink->col residual (z>0): pm <= psink + eps
        pm2 = torch.minimum(pm2, torch.where(z > 0, psink + eps, BIG))
        # bwd residual col->row (y>0): pr <= pm - wS + eps
        bound_r = torch.where(y > 0, pm2[None, :] - wS + eps, BIG).amin(dim=1)
        pr2 = torch.clamp(torch.minimum(pr, bound_r), min=-BIG_D)
        # col->sink residual (cap-z>0): psink <= pm + eps
        bound_s = torch.where(col_cap - z > 0, pm2 + eps, BIG).amin()
        psink2 = torch.clamp(torch.minimum(psink, bound_s), min=-BIG_D)
        pr, pm, psink = pr2, pm2, psink2
    return pr, pm, psink


def transport_superstep(wS, U, supply, col_cap, y, z, pr, pm, psink, eps: int,
                        with_stats: bool = False):
    """One synchronous push/relabel wave over the dense bipartite
    residual graph. Every update is computed from the old state.

    with_stats=True also returns the soltel counters (pushed, relabels,
    saturated, work) as int32 scalar tensors, from this wave's own
    intermediates (obs/soltel.py cols 3..6) — observational only, so
    flows are bit-identical either way."""
    e_row, e_col, e_sink = _excesses(supply, y, z)
    rcf = wS + pr[:, None] - pm[None, :]

    # --- rows push forward along admissible arcs (maximal push via
    # in-row exclusive prefix sums, ascending column order) ---
    r_fwd = U - y
    r_adm = torch.where((r_fwd > 0) & (rcf < 0), r_fwd, 0)
    excl = torch.cumsum(r_adm, 1, dtype=_I32) - r_adm
    delta_f = torch.minimum(torch.clamp(e_row[:, None] - excl, min=0), r_adm)

    # --- columns push: entry 0 = col->sink, entries 1..C = backward
    # col->row (returning flow), allocated in that order ---
    r_s = col_cap - z
    adm_s = torch.where((r_s > 0) & (pm - psink < 0), r_s, 0)
    rc_b = pm[None, :] - pr[:, None] - wS  # cost of bwd arc is -wS
    adm_b = torch.where((y > 0) & (rc_b < 0), y, 0)
    excl_b = adm_s[None, :] + (torch.cumsum(adm_b, 0, dtype=_I32) - adm_b)
    delta_s = torch.minimum(torch.clamp(e_col, min=0), adm_s)
    delta_b = torch.minimum(torch.clamp(e_col[None, :] - excl_b, min=0), adm_b)

    # --- sink pushes back (transient positive excess after a
    # saturate): backward sink->col arcs, residual z, cost 0 ---
    zb_adm = torch.where((z > 0) & (psink - pm < 0), z, 0)
    excl_zb = torch.cumsum(zb_adm, 0, dtype=_I32) - zb_adm
    delta_zb = torch.minimum(torch.clamp(e_sink - excl_zb, min=0), zb_adm)

    y2 = y + delta_f - delta_b
    z2 = z + delta_s - delta_zb

    # --- jump relabels for active nodes that pushed nothing ---
    pushed_row = delta_f.sum(dim=1, dtype=_I32)
    best_row = torch.where(r_fwd > 0, pm[None, :] - wS, -BIG).amax(dim=1)
    relabel_row = (e_row > 0) & (pushed_row == 0)
    pr2 = torch.where(relabel_row, best_row - eps, pr)

    pushed_col = delta_s + delta_b.sum(dim=0, dtype=_I32)
    cand_col = torch.maximum(
        torch.where(y > 0, pr[:, None] + wS, -BIG).amax(dim=0),
        torch.where(r_s > 0, psink, -BIG),
    )
    relabel_col = (e_col > 0) & (pushed_col == 0)
    pm2 = torch.where(relabel_col, cand_col - eps, pm)

    pushed_sink = delta_zb.sum(dtype=_I32)
    cand_sink = torch.where(z > 0, pm, -BIG).amax()
    relabel_sink = (e_sink > 0) & (pushed_sink == 0)
    psink2 = torch.where(relabel_sink, cand_sink - eps, psink)
    if not with_stats:
        return y2, z2, pr2, pm2, psink2

    def total(*xs):
        return sum(torch.sum(x, dtype=_I32) for x in xs)

    stats = (
        total(delta_f, delta_s, delta_b, delta_zb),
        total(relabel_row, relabel_col, relabel_sink),
        total((U > 0) & (y >= U), (col_cap > 0) & (z >= col_cap)),
        total(r_adm > 0, adm_s > 0, adm_b > 0, zb_adm > 0),
    )
    return y2, z2, pr2, pm2, psink2, stats


def _transport_loop(wS, U, supply, col_cap, eps_init, alpha: int,
                    max_supersteps: int, pm_init=None, refine_waves: int = 0,
                    telemetry_cap: int = 0):
    """The cost-scaling phase schedule: each iteration either runs a
    superstep (while active nodes exist) or advances the eps phase;
    exits as soon as the eps=1 phase drains, bounded by max_supersteps.
    Returns (y, z, pm, steps, converged) — pm is the final machine-price
    vector, for carrying into the next round; steps an int32 scalar
    tensor, converged a bool scalar tensor. telemetry_cap > 0 appends
    the int32 [telemetry_cap, SOLTEL_WIDTH] soltel ring."""
    from ..obs import soltel

    C, Mp1 = wS.shape
    dev = wS.device
    tel = soltel.device_ring(telemetry_cap, dev) if telemetry_cap else None
    pr, pm, psink = transport_tighten(wS, U, col_cap, pm_init)
    y = torch.zeros((C, Mp1), dtype=_I32, device=dev)
    z = torch.zeros(Mp1, dtype=_I32, device=dev)
    eps = int(eps_init)
    steps = 0
    done = False
    while not done and steps < max_supersteps:
        e_row, e_col, e_sink = _excesses(supply, y, z)
        if bool((e_row > 0).any() | (e_col > 0).any() | (e_sink > 0)):
            y, z, pr, pm, psink, *stats = transport_superstep(
                wS, U, supply, col_cap, y, z, pr, pm, psink, eps,
                with_stats=bool(telemetry_cap),
            )
            if telemetry_cap:
                active = (torch.sum(e_row > 0, dtype=_I32)
                          + torch.sum(e_col > 0, dtype=_I32) + (e_sink > 0).to(_I32))
                exc_pos = (torch.sum(e_row.clamp(min=0), dtype=_I32)
                           + torch.sum(e_col.clamp(min=0), dtype=_I32)
                           + e_sink.clamp(min=0))
                soltel.device_ring_write(tel, steps, soltel.device_row(
                    eps, active, exc_pos, *stats[0], device=dev))
            steps += 1
        elif eps <= 1:
            done = True
        else:
            eps = max(1, eps // alpha)
            if refine_waves:
                # price refinement: tighten potentials for the CURRENT
                # converged flow at the next eps, then reset only the
                # arcs still violating it
                pr, pm, psink = _price_refine(
                    wS, U, col_cap, y, z, pr, pm, psink, eps, refine_waves
                )
                y, z = transport_saturate_eps(
                    wS, U, col_cap, y, z, pr, pm, psink, eps
                )
            else:
                y, z = transport_saturate(wS, U, col_cap, y, z, pr, pm, psink)
    e_row, e_col, e_sink = _excesses(supply, y, z)
    balanced = ~((e_row != 0).any() | (e_col != 0).any() | (e_sink != 0))
    converged = balanced & done
    out = (y, z, pm, torch.tensor(steps, dtype=_I32, device=dev), converged)
    return out + (tel,) if telemetry_cap else out


def _solve_transport(
    wS,  # int32[C, Mp1] scaled costs (column Mp1-1 = unsched, 0)
    supply,  # int32[C]
    col_cap,  # int32[Mp1]
    eps_init,  # int (or int32 scalar tensor)
    pm0=None,  # optional int32[Mp1] carried machine prices
    alpha: int = 8,
    max_supersteps: int = 20_000,
    refine_waves: int = 0,
    telemetry_cap: int = 0,
):
    """The plain PyTorch version of the transport kernel: same inputs,
    same (y, pm, steps, converged), bit for bit; with telemetry_cap > 0
    also the soltel ring (which the kernel does not write)."""
    U = torch.minimum(supply[:, None], col_cap[None, :])  # fwd arc capacity
    y, _z, pm, steps, converged, *tel = _transport_loop(
        wS, U, supply, col_cap, eps_init, alpha, max_supersteps,
        pm_init=pm0, refine_waves=refine_waves, telemetry_cap=telemetry_cap,
    )
    return (y, pm, steps, converged, *tel)


# ---------------------------------------------------------------------------
# Tiered (continuation-priced) transport: the preemption-on formulation
# ---------------------------------------------------------------------------
#
# With preemption on (graph_manager.go:855-888), placed tasks re-enter
# every round's solve: machine capacity is total slots and a task's
# CURRENT machine offers a cheaper continuation price than a fresh
# placement (costmodel/interface.go:75-79). In aggregate form each cell
# (row g, machine m) prices its first R[g,m] units (the residents) at
# wLo = w - discount and the rest at wHi. A per-cell convex two-tier
# cost is a pair of parallel arcs, so cost-scaling push-relabel stays
# exact: every residual/relabel rule below is the parallel-arc rule
# with the canonical cheapest-first split yA = min(y, R), yB = y - yA.
# This is the plain version of the tiered kernel
# (ops/csrc/transport_tiered.cu), bit for bit.


def transport_saturate_eps_tiered(wLo, wHi, R, U, col_cap, y, z, pr, pm,
                                  psink, eps: int):
    """Phase-start saturation per tier: reset ONLY tiers whose reduced
    cost violates eps-optimality, keeping the rest of the flow. With
    eps=0 it is the full saturate (transport_saturate_tiered in the
    JAX package)."""
    rcl = wLo + pr[:, None] - pm[None, :]
    rch = wHi + pr[:, None] - pm[None, :]
    yA = torch.minimum(y, R)
    yB = y - yA
    yA2 = torch.where(rcl < -eps, R, torch.where(rcl > eps, 0, yA))
    yB2 = torch.where(rch < -eps, U - R, torch.where(rch > eps, 0, yB))
    rcs = pm - psink
    z2 = torch.where(rcs < -eps, col_cap, torch.where(rcs > eps, 0, z))
    return yA2 + yB2, z2


def _price_refine_tiered(wLo, wHi, R, U, col_cap, y, z, pr, pm, psink,
                         eps: int, waves: int):
    """Tiered price refinement: synchronous Bellman-Ford relaxations
    lowering potentials toward eps-optimality of the CURRENT flow, each
    tier's residuals contributing its own constraints (fwd tier A at wLo
    while R-yA>0, fwd tier B at wHi while (U-R)-yB>0; bwd with the signs
    flipped)."""
    yA = torch.minimum(y, R)
    yB = y - yA
    for _ in range(waves):
        bound_m = torch.minimum(
            torch.where(R - yA > 0, wLo + pr[:, None] + eps, BIG).amin(dim=0),
            torch.where((U - R) - yB > 0, wHi + pr[:, None] + eps, BIG).amin(dim=0),
        )
        pm2 = torch.clamp(torch.minimum(pm, bound_m), min=-BIG_D)
        pm2 = torch.minimum(pm2, torch.where(z > 0, psink + eps, BIG))
        bound_r = torch.minimum(
            torch.where(yA > 0, pm2[None, :] - wLo + eps, BIG).amin(dim=1),
            torch.where(yB > 0, pm2[None, :] - wHi + eps, BIG).amin(dim=1),
        )
        pr2 = torch.clamp(torch.minimum(pr, bound_r), min=-BIG_D)
        bound_s = torch.where(col_cap - z > 0, pm2 + eps, BIG).amin()
        psink2 = torch.clamp(torch.minimum(psink, bound_s), min=-BIG_D)
        pr, pm, psink = pr2, pm2, psink2
    return pr, pm, psink


def transport_superstep_tiered(wLo, wHi, R, U, supply, col_cap, y, z, pr, pm,
                               psink, eps: int):
    """One synchronous push/relabel wave over the two-tier residual
    graph: transport_superstep with forward and backward residuals split
    by tier (the cheap tier fills first, the dear tier empties first)."""
    e_row, e_col, e_sink = _excesses(supply, y, z)
    yA = torch.minimum(y, R)
    yB = y - yA
    rcl = wLo + pr[:, None] - pm[None, :]
    rch = wHi + pr[:, None] - pm[None, :]

    # --- rows push forward: tier-A residual at wLo, tier-B at wHi ---
    rA = R - yA
    rB = (U - R) - yB
    r_adm = (torch.where((rA > 0) & (rcl < 0), rA, 0)
             + torch.where((rB > 0) & (rch < 0), rB, 0))
    excl = torch.cumsum(r_adm, 1, dtype=_I32) - r_adm
    delta_f = torch.minimum(torch.clamp(e_row[:, None] - excl, min=0), r_adm)

    # --- columns push: the sink first, then the dear-tier returns over
    # rows ascending, then the cheap-tier returns over rows ascending ---
    r_s = col_cap - z
    adm_s = torch.where((r_s > 0) & (pm - psink < 0), r_s, 0)
    rcb_hi = pm[None, :] - pr[:, None] - wHi  # backward tier B (cost -wHi)
    rcb_lo = pm[None, :] - pr[:, None] - wLo  # backward tier A
    adm_bh = torch.where((yB > 0) & (rcb_hi < 0), yB, 0)
    adm_bl = torch.where((yA > 0) & (rcb_lo < 0), yA, 0)
    excl_bh = adm_s[None, :] + (torch.cumsum(adm_bh, 0, dtype=_I32) - adm_bh)
    excl_bl = (adm_s + adm_bh.sum(dim=0, dtype=_I32))[None, :] + (
        torch.cumsum(adm_bl, 0, dtype=_I32) - adm_bl
    )
    delta_s = torch.minimum(torch.clamp(e_col, min=0), adm_s)
    delta_b = (
        torch.minimum(torch.clamp(e_col[None, :] - excl_bh, min=0), adm_bh)
        + torch.minimum(torch.clamp(e_col[None, :] - excl_bl, min=0), adm_bl)
    )

    # --- sink pushes back (tier-less) ---
    zb_adm = torch.where((z > 0) & (psink - pm < 0), z, 0)
    excl_zb = torch.cumsum(zb_adm, 0, dtype=_I32) - zb_adm
    delta_zb = torch.minimum(torch.clamp(e_sink - excl_zb, min=0), zb_adm)

    y2 = y + delta_f - delta_b
    z2 = z + delta_s - delta_zb

    # --- jump relabels (candidates consider both tiers' residuals) ---
    pushed_row = delta_f.sum(dim=1, dtype=_I32)
    cand_row = torch.maximum(
        torch.where(rA > 0, pm[None, :] - wLo, -BIG).amax(dim=1),
        torch.where(rB > 0, pm[None, :] - wHi, -BIG).amax(dim=1),
    )
    pr2 = torch.where((e_row > 0) & (pushed_row == 0), cand_row - eps, pr)

    pushed_col = delta_s + delta_b.sum(dim=0, dtype=_I32)
    cand_col = torch.maximum(
        torch.maximum(
            torch.where(yA > 0, pr[:, None] + wLo, -BIG).amax(dim=0),
            torch.where(yB > 0, pr[:, None] + wHi, -BIG).amax(dim=0),
        ),
        torch.where(r_s > 0, psink, -BIG),
    )
    pm2 = torch.where((e_col > 0) & (pushed_col == 0), cand_col - eps, pm)

    pushed_sink = delta_zb.sum(dtype=_I32)
    cand_sink = torch.where(z > 0, pm, -BIG).amax()
    psink2 = torch.where(
        (e_sink > 0) & (pushed_sink == 0), cand_sink - eps, psink
    )
    return y2, z2, pr2, pm2, psink2


def _transport_loop_tiered(wLo, wHi, R, U, supply, col_cap, eps_init,
                           alpha: int, max_supersteps: int,
                           refine_waves: int = 0):
    """The tiered phase schedule, cold started: tightening against the
    cheap tier makes the zero flow 0-optimal, since wLo <= wHi.
    Returns (y, z, pm, steps, converged) like _transport_loop."""
    C, Mp1 = wLo.shape
    dev = wLo.device
    pr, pm, psink = transport_tighten(wLo, U, col_cap, None)
    y = torch.zeros((C, Mp1), dtype=_I32, device=dev)
    z = torch.zeros(Mp1, dtype=_I32, device=dev)
    eps = int(eps_init)
    steps = 0
    done = False
    while not done and steps < max_supersteps:
        e_row, e_col, e_sink = _excesses(supply, y, z)
        if bool((e_row > 0).any() | (e_col > 0).any() | (e_sink > 0)):
            y, z, pr, pm, psink = transport_superstep_tiered(
                wLo, wHi, R, U, supply, col_cap, y, z, pr, pm, psink, eps
            )
            steps += 1
        elif eps <= 1:
            done = True
        else:
            eps = max(1, eps // alpha)
            if refine_waves:
                pr, pm, psink = _price_refine_tiered(
                    wLo, wHi, R, U, col_cap, y, z, pr, pm, psink, eps,
                    refine_waves,
                )
            # refined prices keep the eps-optimal flow; without
            # refinement the phase starts from a full saturate (eps 0)
            y, z = transport_saturate_eps_tiered(
                wLo, wHi, R, U, col_cap, y, z, pr, pm, psink,
                eps if refine_waves else 0,
            )
    e_row, e_col, e_sink = _excesses(supply, y, z)
    balanced = ~((e_row != 0).any() | (e_col != 0).any() | (e_sink != 0))
    converged = balanced & done
    return y, z, pm, torch.tensor(steps, dtype=_I32, device=dev), converged


def _solve_transport_tiered(wLo, wHi, R, supply, col_cap, eps_init,
                            alpha: int = 8, max_supersteps: int = 20_000,
                            refine_waves: int = 0):
    """The plain PyTorch version of the tiered transport kernel: R is
    clamped to the cell capacity U = min(supply, col_cap) first. Returns
    (y, pm, steps, converged), bit for bit the kernel's."""
    U = torch.minimum(supply[:, None], col_cap[None, :])
    R = torch.minimum(R, U)
    y, _z, pm, steps, converged = _transport_loop_tiered(
        wLo, wHi, R, U, supply, col_cap, eps_init, alpha, max_supersteps,
        refine_waves=refine_waves,
    )
    return y, pm, steps, converged


# ---------------------------------------------------------------------------
# Bounded solves for the device-resident round
# ---------------------------------------------------------------------------


def read_flag(flag) -> bool:
    """The device round's host read of a solve attempt's converged
    flag: read to decide the full-range retry, or by a round that
    branches on a flag the host does not know yet (the incremental
    tier's escalation, the grouped stage 1). Counted in
    `read_flag.count`."""
    read_flag.count += 1
    return bool(flag)


#: host reads since the count was last set to 0
read_flag.count = 0


def read_branch(values) -> list:
    """The device round's host read of one branch point's predicates
    (int32 scalars stacked into one tensor), in one transfer: the
    decisions that the reference takes with lax.cond on device values.
    Counted in `read_branch.count`."""
    read_branch.count += 1
    return [int(v) for v in values.tolist()]


#: branch reads since the count was last set to 0
read_branch.count = 0


def converged_on_host(converged, known) -> bool:
    """A bounded solve's converged flag on the host: `known` (the last
    element of transport_fori(_tiered)'s result) where the host already
    has it, else one read_flag of the device flag."""
    return known if known is not None else read_flag(converged)


def _scalar(value, like):
    """A 0-dim tensor of like's dtype and device, filled on the device
    (no host-to-device copy)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _true(device):
    return torch.ones((), dtype=torch.bool, device=device)


def _attempts(run, eps0, eps_full, num_supersteps: int, eps0_budget,
              eps0_retry: bool, device):
    """The bounded attempts of transport_fori(_tiered): from eps0 under
    min(eps0_budget, num_supersteps) supersteps, then (eps0_retry) one
    full-range retry under num_supersteps when the first did not
    converge — the first attempt's flag is the one host read, which
    decides it. Returns (y, pm, steps, converged, known): known is True
    when that read found the first attempt converged, else None (the
    flag is on the device only)."""
    if eps0 is None:
        return run(eps_full, num_supersteps) + (None,)
    budget = min(eps0_budget or num_supersteps, num_supersteps)
    y1, pm1, s1, conv1 = run(torch.as_tensor(eps0, dtype=_I32, device=device), budget)
    if not eps0_retry:
        # the caller owns the fallback: the bounded attempt as it is
        return y1, pm1, s1, conv1, None
    if read_flag(conv1):
        return y1, pm1, s1, conv1, True
    y2, pm2, s2, conv2 = run(eps_full, num_supersteps)
    return y2, pm2, s1 + s2, conv2, None


def transport_fori(wS, supply, col_cap, num_supersteps: int, alpha: int = 8,
                   eps0=None, class_degenerate: bool = False,
                   refine_waves: int = 0, eps0_budget: Optional[int] = None,
                   eps0_retry: bool = True):
    """Bounded transport solve for the device round.

    C == 1: the exact closed form (solve_single_class). A class-
    degenerate instance (every row the same costs, asserted by the
    caller): the closed form on the total supply, grants split by class.
    Otherwise the cost-scaling solve through ops.transport_solve — the
    kernel on the card, the plain version on the CPU — from eps0 (an
    int or an int32 scalar tensor) under min(eps0_budget,
    num_supersteps) supersteps, retried once from the full range when
    the short start does not converge (unless eps0_retry is False: the
    caller then owns the fallback); the retry decision is a host read
    (read_flag). Returns (y, pm, steps, converged) as tensors, pm and
    steps zero on the closed forms, and what the host knows of the
    flag: True on the closed forms and after a converged first attempt,
    else None (converged_on_host reads it where a round needs it)."""
    C, _Mp1 = wS.shape
    zero, true = _scalar(0, col_cap), _true(wS.device)
    if C == 1:
        y = solve_single_class(wS[0], supply[0], col_cap)[None, :]
        return y, torch.zeros_like(col_cap), zero, true, True
    if class_degenerate:
        y_tot = solve_single_class(wS[0], supply.sum(dtype=_I32), col_cap)
        return (split_grants_by_class(y_tot, supply), torch.zeros_like(col_cap),
                zero, true, True)

    from .. import ops

    def run(eps_init, budget):
        return ops.transport_solve(
            wS, supply, col_cap, eps_init, alpha=alpha,
            max_supersteps=budget, refine_waves=refine_waves,
        )

    eps_full = wS.abs().amax().clamp(min=1)
    return _attempts(run, eps0, eps_full, num_supersteps, eps0_budget,
                     eps0_retry, wS.device)


def transport_fori_tiered(wLo, wHi, R, supply, col_cap, num_supersteps: int,
                          alpha: int = 8, eps0=None, refine_waves: int = 0):
    """Bounded tiered transport solve — the preemption-on twin of
    transport_fori: the exact closed form for a single row, else
    ops.transport_solve_tiered (the tiered kernel on the card, its plain
    version on the CPU) from eps0 with one full-range retry decided by
    one host read. Returns (y, pm, steps, converged, known) as
    transport_fori does."""
    C, _Mp1 = wLo.shape
    if C == 1:
        R1 = torch.minimum(R, torch.minimum(supply[:, None], col_cap[None, :]))
        y = solve_single_class_tiered(wLo[0], wHi[0], R1[0], supply[0], col_cap)
        return (y[None, :], torch.zeros_like(col_cap), _scalar(0, col_cap),
                _true(wLo.device), True)

    from .. import ops

    def run(eps_init, budget):
        return ops.transport_solve_tiered(
            wLo, wHi, R, supply, col_cap, eps_init, alpha=alpha,
            max_supersteps=budget, refine_waves=refine_waves,
        )

    eps_full = wHi.abs().amax().clamp(min=1)
    return _attempts(run, eps0, eps_full, num_supersteps, None, True, wLo.device)


def solve_layered_host(lp: LayeredProblem, *, pad, solve,
                       max_supersteps: int, device="cpu") -> LayeredResult:
    """The host harness around a device transport solve: cost shift
    (subtract the unsched cost so the escape column is 0), padded
    geometry, int32 overflow guard, closed-form dispatch for C==1,
    class-degenerate and row-constant instances, the short-then-full
    eps attempts loop, and objective reconstruction.

    pad(M, C) -> (Mp, n_scale); solve(wS, supply, col_cap, eps_init)
    -> (y, steps, converged), with int32 tensors on `device` and a
    Python int eps_init."""
    C, M = lp.cost_cm.shape
    supply = lp.supply.astype(np.int64)
    total = int(supply.sum())
    if total == 0:
        return LayeredResult(
            y=np.zeros((C, M), np.int64), num_unsched=0, objective=0, supersteps=0
        )
    # Shifted per-unit cost: placing costs (e + cost[c,m]), leaving
    # unscheduled costs u (per row when row_unsched_cost is set);
    # subtract u so the unsched column is 0 for every row.
    if lp.row_unsched_cost is not None:
        u_row = np.asarray(lp.row_unsched_cost, np.int64)
        assert u_row.shape == (C,), f"row_unsched_cost must be [{C}]"
    else:
        u_row = np.full(C, int(lp.unsched_cost), np.int64)
    w = lp.cost_cm.astype(np.int64) + int(lp.ec_cost) - u_row[:, None]
    Mp, n_scale = pad(M, C)
    wP = np.zeros((C, Mp), np.int64)
    wP[:, :M] = w
    col_cap = np.zeros(Mp, np.int64)
    col_cap[:M] = lp.col_cap
    col_cap[-1] = total

    max_w = int(np.abs(wP).max())
    if max_w * n_scale >= COST_SCALE_LIMIT:
        raise OverflowError(
            f"scaled layered costs overflow int32: max|w|={max_w} * {n_scale}"
        )

    if C == 1:
        y_np = solve_single_class_np(wP[0], total, col_cap)[None, :]
        steps_taken = 0
    elif (wP == wP[0]).all():
        # Class-degenerate (all cost rows equal): exact closed form on
        # the total supply, grants split arbitrarily by class — the
        # iterative solve herds pathologically on identical costs.
        y_tot = solve_single_class_np(wP[0], total, col_cap)
        y_np = split_grants_by_class(y_tot, supply)
        steps_taken = 0
    elif (w == w[:, :1]).all():
        # Row-constant (each row machine-uniform, rows differ): the
        # fractional-knapsack closed form.
        y_np = solve_row_constant_np(
            w[:, 0].astype(np.int32), supply.astype(np.int32),
            col_cap.astype(np.int32),
        )
        steps_taken = 0
    else:
        wS = torch.as_tensor((wP * n_scale).astype(np.int32), device=device)
        sup = torch.as_tensor(supply.astype(np.int32), device=device)
        cap = torch.as_tensor(col_cap.astype(np.int32), device=device)
        eps_full = int(max(1, max_w * n_scale))
        eps0 = choose_eps0(n_scale, eps_full, total, int(lp.col_cap.sum()))
        attempts = [eps0]
        if eps0 != eps_full:
            attempts.append(eps_full)
        y = None
        converged = False
        # supersteps accumulate ACROSS attempts; each attempt's steps
        # and converged flag are read back on the host before the next
        steps_taken = 0
        for eps_init in attempts:
            y, steps, converged = solve(wS, sup, cap, eps_init)
            steps_taken += int(steps)
            if bool(converged):
                break
        if not bool(converged):
            raise RuntimeError(
                f"layered transport solve did not converge in "
                f"{max_supersteps} supersteps"
            )
        y_np = y.cpu().numpy().astype(np.int64)
    y_real = y_np[:, :M]
    placed = int(y_real.sum())
    unplaced_row = supply - y_real.sum(axis=1)
    objective = int((u_row * unplaced_row).sum()) + int(
        ((lp.cost_cm.astype(np.int64) + int(lp.ec_cost)) * y_real).sum()
    )
    return LayeredResult(
        y=y_real,
        num_unsched=total - placed,
        objective=objective,
        supersteps=steps_taken,
    )


class LayeredTransportSolver:
    """The layered transport backend: understands only the aggregate
    layered topology and is dispatched via ``solve_layered`` (AutoSolver
    hands it every collapsible graph). The iterative solve runs on
    `device` — the CUDA kernel on ``"cuda"`` (the default; raises when
    no CUDA device is present), the plain PyTorch version on ``"cpu"``.

    ``telemetry`` is the soltel ring's capacity (None: obs/soltel's
    default). The kernels write no ring, so, as the JAX package skips
    the ring wherever its Pallas kernel runs, a ring is made only where
    the plain loop runs anyway: on the CPU. On the card the superstep
    count is all there is (`last_supersteps`), and flows are the same
    either way."""

    def __init__(self, alpha: int = 8, max_supersteps: int = 20_000,
                 telemetry: Optional[int] = None, device="cuda"):
        from ..utils.device import resolve_device

        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self.last_supersteps = 0
        self.last_telemetry = None

    def reset(self) -> None:
        pass

    def solve_layered(self, lp: LayeredProblem) -> LayeredResult:
        from ..obs import soltel
        from ..ops import transport_solve

        tel_cap = soltel.resolve_cap(self.telemetry)
        if self.device.type != "cpu":
            tel_cap = 0  # the kernel runs: keep it, make no ring
        captured = []  # (ring, steps, converged) of each attempt

        def solve(wS, sup, cap, eps_init):
            if tel_cap:
                y, _pm, steps, converged, tel = _solve_transport(
                    wS, sup, cap, eps_init, alpha=self.alpha,
                    max_supersteps=self.max_supersteps, telemetry_cap=tel_cap,
                )
                captured.append((tel, steps, converged))
            else:
                y, _pm, steps, converged = transport_solve(
                    wS, sup, cap, eps_init,
                    alpha=self.alpha, max_supersteps=self.max_supersteps,
                )
            return y, steps, converged

        def decode_last(converged=None):
            if not captured:
                return None
            tel, steps, conv = captured[-1]
            return soltel.decode(
                tel, int(steps), tel_cap, "layered", self.max_supersteps,
                converged=bool(conv) if converged is None else converged,
                nodes=int(lp.supply.shape[0]), arcs=int(lp.cost_cm.size),
            )

        self.last_telemetry = None
        try:
            res = solve_layered_host(
                lp, pad=pad_geometry, solve=solve,
                max_supersteps=self.max_supersteps, device=self.device,
            )
        except KernelError:
            raise
        except RuntimeError as e:
            self.last_supersteps = self.max_supersteps  # budget exhausted
            tel = decode_last(converged=False)
            self.last_telemetry = tel
            if tel is not None and not isinstance(e, soltel.SolverStallError):
                raise soltel.SolverStallError(
                    str(e), reason=soltel.detect_stall(tel), telemetry=tel,
                ) from e
            raise
        self.last_supersteps = res.supersteps
        self.last_telemetry = decode_last()
        return res
