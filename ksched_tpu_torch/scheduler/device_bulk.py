"""Device-resident bulk scheduling: the whole round on the card.

The ENTIRE cluster state — task table, placements, per-PU occupancy,
machine membership — lives in tensors on one device, and one scheduling
round (capacity refresh -> class census -> transport solve -> flow
decode -> placement apply) is a sequence of tensor operations and one
solve per attempt on that device. Rounds chain on the device: the only
host read of a round is a solve attempt's converged flag, which decides
the full-range retry (solver/layered.py `read_flag`), and closed-form
rounds read nothing. Stats come back as device tensors; `fetch_stats`
materializes them after the timed region, where the reference pushes
its bindings (cmd/k8sscheduler/scheduler.go:146-187).

The solve is the dense layered transport: `ops.transport_solve` (kernel
B1) with preemption off, `ops.transport_solve_tiered` (kernel B2) for
the continuation-priced re-solve with preemption on; the closed forms
serve single-row, class-degenerate and row-constant rounds. The decode
rank-matches placed tasks to machine grants with integer row gathers
and exclusive in-group ranks, then splits each machine's grant across
its PUs — every count exact in int32.

This slice ports the ungrouped modes: the per-round round core with
preemption off and on (the full tiered re-solve every round), host
mutations, and steady churn rounds whose random draws come in as
tensors (`draw_steady` makes them from a `torch.Generator`). Group mode,
the stability-aware and three-tier preemption schemes, realized-cost
tracking and replay rounds raise NotImplementedError naming their
ROADMAP item.

Graph semantics are those of the host BulkCluster: the same aggregate
topology, pin-on-place accounting with preemption off, keep-arcs
semantics with it on (graph_manager.go:855-888).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..solver.layered import (
    COST_SCALE_LIMIT,
    _true,
    choose_eps0,
    pad_geometry,
    solve_row_constant,
    transport_fori,
    transport_fori_tiered,
    validate_alpha,
    validate_job_unsched_cost,
)
from ..utils.device import resolve_device

_I32 = torch.int32


class DeviceClusterState(NamedTuple):
    live: torch.Tensor  # bool[Tcap]
    cls: torch.Tensor  # int32[Tcap]
    job: torch.Tensor  # int32[Tcap]
    pu: torch.Tensor  # int32[Tcap]; PU index or -1
    pu_running: torch.Tensor  # int32[num_pus]
    machine_enabled: torch.Tensor  # bool[M]
    #: interchangeability group per task (group mode; all-zero here)
    grp: torch.Tensor  # int32[Tcap]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to ksched_tpu_torch yet (ROADMAP queue A "
        f"item {item})"
    )


def _count(idx, n: int):
    """int32[n] counts of the values in idx; entries equal to n (the
    sentinel) land in a spare bucket and are dropped."""
    out = torch.zeros(n + 1, dtype=_I32, device=idx.device)
    out.index_add_(0, idx.long(), torch.ones_like(idx, dtype=_I32))
    return out[:n]


def draw_steady(generator: torch.Generator, task_capacity: int,
                num_task_classes: int, num_jobs: int):
    """One steady round's random draws, made on the generator's device:
    (done_u float32[Tcap] — a row completes if placed and done_u <
    churn_prob; new_cls, new_job int32[Tcap] — the class and job of the
    arrival admitted into each free row; window_offset int32 scalar —
    the rotation of the decode window)."""
    dev = generator.device
    done_u = torch.rand(task_capacity, generator=generator, device=dev)
    new_cls = torch.randint(0, num_task_classes, (task_capacity,),
                            generator=generator, device=dev, dtype=_I32)
    new_job = torch.randint(0, num_jobs, (task_capacity,),
                            generator=generator, device=dev, dtype=_I32)
    window_offset = torch.randint(0, 1 << 30, (), generator=generator,
                                  device=dev, dtype=_I32)
    return done_u, new_cls, new_job, window_offset


class DeviceBulkCluster:
    """Flat device-tensor cluster; every round runs on `device` (the
    card by default; raises when there is none)."""

    def __init__(
        self,
        num_machines: int,
        pus_per_machine: int,
        slots_per_pu: int,
        num_jobs: int,
        num_task_classes: int = 1,
        task_capacity: int = 2048,
        unsched_cost: int = 5,
        ec_cost: int = 2,
        class_cost_fn: Optional[Callable] = None,  # census[M,C] -> int32[C,M]
        supersteps: Optional[int] = None,
        decode_width: Optional[int] = None,  # steady-round decode window
        alpha: int = 8,  # eps-schedule divisor for iterative solves
        job_unsched_cost: Optional[np.ndarray] = None,
        preemption: bool = False,
        continuation_discount: int = 1,
        preempt_every: int = 1,
        preempt_drift: int = 0,
        preempt_global_every: int = 0,
        preempt_incr_budget: Optional[int] = None,
        track_realized_cost: bool = False,
        num_groups: int = 0,
        refine_waves: int = 8,
        device="cuda",
    ) -> None:
        if num_groups > 0:
            raise _not_ported("group mode (num_groups > 0)", "5a")
        if preempt_every < 1:
            raise ValueError("preempt_every must be >= 1")
        if preempt_drift < 0:
            raise ValueError("preempt_drift must be >= 0")
        if preempt_global_every < 0:
            raise ValueError("preempt_global_every must be >= 0")
        for name, value, default in (
            ("preempt_every", preempt_every, 1),
            ("preempt_drift", preempt_drift, 0),
            ("preempt_global_every", preempt_global_every, 0),
            ("preempt_incr_budget", preempt_incr_budget, None),
            ("track_realized_cost", track_realized_cost, False),
        ):
            if value != default:
                raise _not_ported(
                    f"{name}={value!r} (stability-aware / three-tier "
                    "preemption)", "5b")
        self.device = resolve_device(device)
        self.M = num_machines
        self.P = pus_per_machine
        self.S = slots_per_pu
        self.J = num_jobs
        self.C = num_task_classes
        self.num_pus = num_machines * pus_per_machine
        self.Tcap = int(task_capacity)
        self.unsched_cost = int(unsched_cost)
        self.ec_cost = int(ec_cost)
        self.class_cost_fn = class_cost_fn
        self.alpha = validate_alpha(alpha)
        # Per-job unsched costs (graph_manager.go:1291-1305): (job,
        # class) pairs become distinct commodities, G = J*C rows,
        # g = j*C + c.
        self.job_unsched_cost = validate_job_unsched_cost(
            job_unsched_cost, num_jobs
        )
        self.per_job = self.job_unsched_cost is not None
        self.G = num_jobs * num_task_classes if self.per_job else num_task_classes
        # Price refinement between eps phases (solver/layered.py
        # _price_refine) for the iterative solves.
        self.refine_waves = int(refine_waves)
        # Preemption (keep-arcs semantics, graph_manager.go:855-888):
        # every round re-solves PLACED tasks too; staying is discounted
        # by `continuation_discount`, machine capacity counts total
        # slots. The round emits PLACE / MIGRATE / PREEMPT counts.
        self.preemption = bool(preemption)
        self.continuation_discount = int(continuation_discount)
        if self.preemption and continuation_discount < 0:
            raise ValueError("continuation_discount must be >= 0")
        if decode_width is not None:
            if decode_width <= 0:
                raise ValueError(
                    f"decode_width must be positive, got {decode_width}"
                )
            if decode_width >= task_capacity:
                decode_width = None  # wider than the pool = the full path
        self.decode_width = None if decode_width is None else int(decode_width)
        # Degenerate = every row shares one cost row: the closed form.
        jc = self.job_unsched_cost
        self.class_degenerate = class_cost_fn is None and (
            jc is None or bool((jc == jc[0]).all())
        )
        # Row-constant: each row machine-uniform, rows differ — the
        # fractional-knapsack closed form.
        self.row_constant = self.per_job and class_cost_fn is None
        # A positive discount makes cells residency-dependent.
        if self.preemption and self.continuation_discount > 0:
            self.class_degenerate = False
            self.row_constant = False
        self.supersteps = int(
            supersteps if supersteps is not None
            else (
                1
                if (self.G == 1 or self.class_degenerate or self.row_constant)
                else 16384
            )
        )
        # Padded transport columns: [machines | zero-cap padding | unsched]
        self.Mp, self.n_scale = pad_geometry(num_machines, self.G)
        # The one-hot decode's [W, G] ranks scale with G; beyond ~2M
        # G*M cells the sort-based ranks win.
        self.use_sorted_decode = self.G * self.M >= (1 << 21)
        # Per-row escape costs: row g = j*C + c escapes at job j's cost.
        self.u_row = torch.as_tensor(
            np.repeat(self.job_unsched_cost, self.C).astype(np.int32)
            if self.per_job
            else np.full(self.G, self.unsched_cost, np.int32),
            device=self.device,
        )
        dev = self.device
        self.state = DeviceClusterState(
            live=torch.zeros(self.Tcap, dtype=torch.bool, device=dev),
            cls=torch.zeros(self.Tcap, dtype=_I32, device=dev),
            job=torch.zeros(self.Tcap, dtype=_I32, device=dev),
            pu=torch.full((self.Tcap,), -1, dtype=_I32, device=dev),
            pu_running=torch.zeros(self.num_pus, dtype=_I32, device=dev),
            machine_enabled=torch.ones(self.M, dtype=torch.bool, device=dev),
            grp=torch.zeros(self.Tcap, dtype=_I32, device=dev),
        )
        self.last_stats: Optional[dict] = None
        self.last_admitted = None  # device int32 from the latest add_tasks

    # ------------------------------------------------------------------
    # the round's parts
    # ------------------------------------------------------------------

    def _i32(self, value):
        return torch.full((), value, dtype=_I32, device=self.device)

    def census_of(self, state: DeviceClusterState):
        """Per-machine running-class census [M, C] (the vectorized
        WhareMapStats, whare_map_stats.proto:12-18)."""
        M, C = self.M, self.C
        placed = state.live & (state.pu >= 0)
        machine = state.pu.clamp(0, self.num_pus - 1) // self.P
        idx = torch.where(placed, machine * C + state.cls, M * C)
        return _count(idx, M * C).view(M, C)

    def _costs(self, state):
        """(cost_eff int32[G, M], w int32[G, M]): the effective per-unit
        place cost and the solve's shifted cost (minus the row's escape
        cost, so the escape column is 0)."""
        if self.class_cost_fn is not None:
            cost_cm = self.class_cost_fn(self.census_of(state)).to(_I32)
        else:
            cost_cm = torch.zeros((self.C, self.M), dtype=_I32, device=self.device)
        # row g = j*C + c carries class c's cost row
        cost_gm = cost_cm.repeat(self.J, 1) if self.per_job else cost_cm
        cost_eff = cost_gm + self.ec_cost
        return cost_eff, cost_eff - self.u_row[:, None]

    def _padded(self, x):
        """[G, M] -> [G, Mp], zero in the padding and escape columns."""
        out = torch.zeros((x.shape[0], self.Mp), dtype=_I32, device=self.device)
        out[:, : self.M] = x
        return out

    def _col_cap(self, machine_cap, total):
        col_cap = torch.zeros(self.Mp, dtype=_I32, device=self.device)
        col_cap[: self.M] = machine_cap
        col_cap[self.Mp - 1] = total
        return col_cap

    def _window(self, mask, width: int, window_offset):
        """Compact `width` rows of `mask` into a decode window: the
        cyclic rank interval [off, off+width) of the masked rows, each
        rank's row found by binary search in the running count (ranks in
        the valid prefix are distinct, so no row enters twice). The
        offset rotates only when the window binds. Returns (total
        masked, idx int32[width] with Tcap for invalid slots, valid)."""
        Tcap = self.Tcap
        cum = torch.cumsum(mask.to(_I32), 0, dtype=_I32)
        n = cum[-1]
        off = self._i32(0) if window_offset is None else window_offset
        off = torch.where(n > width, off, 0)
        denom = torch.clamp(n, min=1)
        ar = torch.arange(width, dtype=_I32, device=self.device)
        target = (off % denom + ar) % denom
        idx = torch.searchsorted(cum, target + 1).to(_I32)
        valid = ar < torch.clamp(n, max=width)
        idx = torch.where(valid, idx.clamp(0, Tcap - 1), Tcap)
        return n, idx, valid

    def rank_match_decode(self, g_safe, grants, pu_free):
        """Rank-match participant rows to machine grants — the decode of
        both round flavors. g_safe int32[W] holds each row's group
        (sentinel G = not participating), grants int32[G, M] the solve's
        per-group machine grants, pu_free int32[num_pus] the slots the
        grants may occupy. Returns (granted bool[W], pu_abs int32[W]);
        pu_abs is meaningful only where granted.

        A row's exclusive in-group rank comes from a one-hot cumsum
        ([W, G], for few groups) or one stable sort (many groups); its
        group's cumulative-grant row is an integer row gather, so every
        count stays exact."""
        Gn, M, P = self.G, self.M, self.P
        W = g_safe.shape[0]
        dev = self.device
        part = g_safe < Gn
        if self.use_sorted_decode:
            order = torch.sort(g_safe, stable=True).indices
            counts = _count(g_safe, Gn + 1)
            starts = torch.cumsum(counts, 0, dtype=_I32) - counts
            rank_sorted = torch.arange(W, dtype=_I32, device=dev) - starts[g_safe[order]]
            rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
        else:
            onehot = (g_safe[:, None] == torch.arange(Gn, dtype=_I32, device=dev)).to(_I32)
            cum_oh = torch.cumsum(onehot, 0, dtype=_I32)
            rank = ((cum_oh - onehot) * onehot).sum(dim=1, dtype=_I32)
        quota = torch.cat([grants.sum(dim=1, dtype=_I32),
                           torch.zeros(1, dtype=_I32, device=dev)])
        granted = part & (rank < quota[g_safe])

        # group row -> machine via the row's cumulative grants
        g_clip = g_safe.clamp(0, Gn - 1)
        cum_t = torch.cumsum(grants, 1, dtype=_I32)[g_clip]  # [W, M]
        offs = torch.cumsum(grants, 0, dtype=_I32) - grants  # [G, M]
        cmp = cum_t <= rank[:, None]
        machine = cmp.sum(dim=1, dtype=_I32)
        excl_at = torch.where(cmp, cum_t, 0).amax(dim=1)
        m_clip = machine.clamp(max=M - 1)
        slot = offs[g_clip, m_clip] + (rank - excl_at)  # within-machine slot

        # split each machine's grant across its PUs in slot order
        t_m = grants.sum(dim=0, dtype=_I32)
        pf2 = pu_free.view(M, P)
        exclg = torch.cumsum(pf2, 1, dtype=_I32) - pf2
        grants_pu = torch.minimum(torch.clamp(t_m[:, None] - exclg, min=0), pf2)
        cumg = torch.cumsum(grants_pu, 1, dtype=_I32)
        pu_in = (cumg[m_clip] <= slot[:, None]).sum(dim=1, dtype=_I32)
        return granted, machine * P + pu_in

    def round_core(self, state: DeviceClusterState, decode_width=None,
                   window_offset=None):
        """One preemption-off scheduling round. decode_width bounds the
        decode to a compacted window of that many unplaced rows (the
        admission-batch bound, k8sclient/client.go:153-193): tasks
        beyond it stay pending; window_offset (int32 scalar) rotates
        which backlog ranks the window covers. decode_width=None decodes
        all Tcap rows (the one-shot round). Returns (state, stats)."""
        M, P, S, C, Tcap = self.M, self.P, self.S, self.C, self.Tcap
        Gn, num_pus, n_scale = self.G, self.num_pus, self.n_scale
        pu_free = torch.where(
            state.machine_enabled.repeat_interleave(P), S - state.pu_running, 0
        )
        machine_free = pu_free.view(M, P).sum(dim=1, dtype=_I32)

        unplaced = state.live & (state.pu < 0)
        if decode_width is None:
            backlog = unplaced.sum(dtype=_I32)
            idx = None  # identity window
            valid, cls_w, job_w = unplaced, state.cls, state.job
        else:
            backlog, idx, valid = self._window(unplaced, int(decode_width),
                                               window_offset)
            rows = idx.clamp(0, Tcap - 1)
            cls_w = torch.where(valid, state.cls[rows], C)
            job_w = torch.where(valid, state.job[rows], 0)
        g_w = job_w * C + cls_w if self.per_job else cls_w
        g_safe = torch.where(valid, g_w, Gn)
        supply = _count(g_safe, Gn)
        total = supply.sum(dtype=_I32)

        cost_eff, w = self._costs(state)
        # int32 headroom guard: flagged in stats, raised by fetch_stats
        cost_overflow = w.abs().amax() >= COST_SCALE_LIMIT // n_scale
        wS = self._padded(w * n_scale)
        col_cap = self._col_cap(machine_free, total)
        # Cold-started every round: carried prices flatten reduced
        # costs and recreate the identical-cost herding pathology.
        if self.row_constant:
            y = solve_row_constant(w[:, 0], supply, col_cap)
            solve_steps, converged = self._i32(0), _true(self.device)
        else:
            eps_full = wS.abs().amax().clamp(min=1)
            y, _pm, solve_steps, converged = transport_fori(
                wS, supply, col_cap, self.supersteps, alpha=self.alpha,
                eps0=choose_eps0(n_scale, eps_full, total,
                                 machine_free.sum(dtype=_I32)),
                class_degenerate=self.class_degenerate,
                refine_waves=self.refine_waves,
            )
        y_real = y[:, :M]

        # ---- decode: rank-match placed tasks to machine grants ----
        placed_w, pu_abs = self.rank_match_decode(g_safe, y_real, pu_free)
        if idx is None:
            new_pu = torch.where(placed_w, pu_abs, state.pu)
        else:
            # scatter the window's placements back; rows beyond Tcap
            # (invalid or unplaced) land in a spare slot and are dropped
            tgt = torch.where(placed_w, idx, Tcap)
            new_pu = torch.cat([state.pu, state.pu[:1]]).scatter_(
                0, tgt.long(), pu_abs)[:Tcap]
        pr_idx = torch.where(placed_w, pu_abs, num_pus)
        pu_running = _count(pr_idx, num_pus) + state.pu_running
        placed_count = placed_w.sum(dtype=_I32)
        # unscheduled counts the WHOLE backlog left pending (solver
        # escapes + rows beyond the decode window)
        placed_cost = (cost_eff * y_real).sum(dtype=_I32)
        if self.per_job:
            g_all = torch.where(unplaced, state.job * C + state.cls, Gn)
            backlog_g = _count(g_all, Gn)
            placed_g = y_real.sum(dim=1, dtype=_I32)
            objective = (self.u_row * (backlog_g - placed_g)).sum(dtype=_I32) + placed_cost
        else:
            objective = self.unsched_cost * (backlog - placed_count) + placed_cost
        stats = {
            "placed": placed_count,
            "unscheduled": backlog - placed_count,
            "converged": converged,
            "cost_overflow": cost_overflow,
            "objective": objective,
            "live": state.live.sum(dtype=_I32),
            # solver supersteps this round (0 on closed-form paths)
            "supersteps": solve_steps,
        }
        return state._replace(pu=new_pu, pu_running=pu_running), stats

    def round_core_preempt(self, state: DeviceClusterState, decode_width=None,
                           window_offset=None):
        """Preemption-on round (keep-arcs semantics, graph_manager.go:
        855-888): every live task re-solves. Staying on the current
        machine is discounted, moving pays full price, escaping pays the
        row's unsched cost; machine capacity is TOTAL slots. Decode: per
        cell (row, machine), min(grant, residents) residents are kept in
        row order; the remaining grants go to movers (displaced
        residents + backlog): MIGRATE for re-granted residents, PLACE
        for fresh tasks, PREEMPT for residents left without a grant. A
        displaced resident is never re-granted its own machine, so the
        three kinds are disjoint.

        decode_width bounds the MOVER decode to a compacted window, as
        round_core's does for the backlog; movers beyond a binding
        window keep pu=-1 and re-enter the next solve."""
        M, P, S, C, Tcap = self.M, self.P, self.S, self.C, self.Tcap
        Gn, num_pus, n_scale = self.G, self.num_pus, self.n_scale
        discount = self.continuation_discount
        dev = self.device
        enabled_pu = state.machine_enabled.repeat_interleave(P)
        live = state.live
        placed = live & (state.pu >= 0)
        cur_pu = state.pu.clamp(0, num_pus - 1)
        cur_m = torch.where(placed, cur_pu // P, M)  # sentinel M
        g_t = state.job * C + state.cls if self.per_job else state.cls

        g_safe = torch.where(live, g_t, Gn)
        supply = _count(g_safe, Gn)
        total = supply.sum(dtype=_I32)
        col_cap_m = torch.where(state.machine_enabled, P * S, 0).to(_I32)

        cost_eff, w = self._costs(state)
        cost_overflow = (w.abs().amax() + discount) >= COST_SCALE_LIMIT // n_scale

        # resident census per cell [G, M]
        cell = torch.where(placed, g_t * M + cur_m, Gn * M)
        R_real = _count(cell, Gn * M).view(Gn, M)

        wS_hi = self._padded(w * n_scale)
        wS_lo = wS_hi.clone()
        wS_lo[:, :M] -= discount * n_scale
        R_pad = self._padded(R_real)
        col_cap = self._col_cap(col_cap_m, total)
        eps_full = wS_hi.abs().amax().clamp(min=1)
        # full-unit start for the tiered re-solve (short=n_scale)
        eps0 = choose_eps0(n_scale, eps_full, total, col_cap_m.sum(dtype=_I32),
                           short=n_scale)
        if discount == 0 and self.row_constant:
            y = solve_row_constant(w[:, 0], supply, col_cap)
            solve_steps, converged = self._i32(0), _true(dev)
        elif discount == 0:
            # tiers coincide: the ordinary solve is exact
            y, _pm, solve_steps, converged = transport_fori(
                wS_hi, supply, col_cap, self.supersteps, alpha=self.alpha,
                eps0=eps0, class_degenerate=self.class_degenerate,
                refine_waves=self.refine_waves,
            )
        else:
            y, _pm, solve_steps, converged = transport_fori_tiered(
                wS_lo, wS_hi, R_pad, supply, col_cap, self.supersteps,
                alpha=self.alpha, eps0=eps0, refine_waves=self.refine_waves,
            )
        y_real = y[:, :M]

        # ---- decode ----
        retained = torch.minimum(y_real, R_real)  # residents kept
        rem = y_real - retained  # grants for movers
        # per-cell resident ranks (row order) via one stable sort
        order = torch.sort(cell, stable=True).indices
        counts = _count(cell, Gn * M + 1)
        starts = torch.cumsum(counts, 0, dtype=_I32) - counts
        rank_sorted = torch.arange(Tcap, dtype=_I32, device=dev) - starts[cell[order]]
        rank_cell = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
        ret_flat = torch.cat([retained.reshape(-1), torch.zeros(1, dtype=_I32, device=dev)])
        stay = placed & (rank_cell < ret_flat[cell])

        # movers: every live task not staying; their grants fill the
        # slots left after stays
        mover = live & ~stay
        pu_stay = _count(torch.where(stay, cur_pu, num_pus), num_pus)
        pu_free_mv = torch.where(enabled_pu, S - pu_stay, 0)
        if decode_width is None:
            g_mv = torch.where(mover, g_t, Gn)
            granted, pu_abs = self.rank_match_decode(g_mv, rem, pu_free_mv)
            new_pu = torch.where(stay, state.pu, torch.where(granted, pu_abs, -1))
            granted_full = granted & mover
        else:
            _n_mv, idx, valid = self._window(mover, int(decode_width), window_offset)
            g_mv_w = torch.where(valid, g_t[idx.clamp(0, Tcap - 1)], Gn)
            granted_w, pu_abs_w = self.rank_match_decode(g_mv_w, rem, pu_free_mv)
            tgt = torch.where(granted_w, idx, Tcap).long()
            base_pu = torch.where(stay, state.pu, -1)
            new_pu = torch.cat([base_pu, base_pu[:1]]).scatter_(0, tgt, pu_abs_w)[:Tcap]
            granted_full = torch.zeros(Tcap + 1, dtype=torch.bool, device=dev).scatter_(
                0, tgt, True)[:Tcap]
        final_on = live & (new_pu >= 0)
        pu_running = _count(torch.where(final_on, new_pu, num_pus), num_pus)

        # objective: placements at the effective route cost, retained
        # residents rebated by the discount, escapes at the row's cost
        objective = (
            (cost_eff * y_real).sum(dtype=_I32)
            - discount * retained.sum(dtype=_I32)
            + (self.u_row * (supply - y_real.sum(dim=1, dtype=_I32))).sum(dtype=_I32)
        )
        stats = {
            "placed": (granted_full & ~placed).sum(dtype=_I32),
            "migrated": (granted_full & placed).sum(dtype=_I32),
            "preempted": (placed & ~stay & ~granted_full).sum(dtype=_I32),
            "unscheduled": total - y_real.sum(dtype=_I32),
            "converged": converged,
            "cost_overflow": cost_overflow,
            "objective": objective,
            "live": live.sum(dtype=_I32),
            "supersteps": solve_steps,
        }
        return state._replace(pu=new_pu, pu_running=pu_running), stats

    def _round(self, state, decode_width=None, window_offset=None):
        core = self.round_core_preempt if self.preemption else self.round_core
        return core(state, decode_width=decode_width, window_offset=window_offset)

    def _occupy(self, state: DeviceClusterState, count, cls, job):
        """Occupy the first `count` free rows, row t taking class cls[t]
        and job job[t] (int32[Tcap]). Returns (state, admitted):
        admitted < count when the task pool is exhausted."""
        free_rank = torch.cumsum(~state.live, 0, dtype=_I32) - 1
        newmask = ~state.live & (free_rank < count)
        return state._replace(
            live=state.live | newmask,
            cls=torch.where(newmask, cls, state.cls),
            job=torch.where(newmask, job, state.job),
            grp=torch.where(newmask, 0, state.grp),
            pu=torch.where(newmask, -1, state.pu),
        ), newmask.sum(dtype=_I32)

    def admit(self, state: DeviceClusterState, jobs, classes, count: int):
        """Occupy the first `count` free rows with the first `count`
        entries of (jobs, classes). Returns (state, admitted)."""
        src = (torch.cumsum(~state.live, 0, dtype=_I32) - 1).clamp(0, self.Tcap - 1)
        return self._occupy(state, count, classes[src], jobs[src])

    def _retire(self, state: DeviceClusterState, done):
        """Retire the live rows where `done` (bool[Tcap]) holds, freeing
        their slots."""
        done = done & state.live
        dec = _count(torch.where(done & (state.pu >= 0), state.pu, self.num_pus),
                     self.num_pus)
        return state._replace(
            live=state.live & ~done,
            pu=torch.where(done, -1, state.pu),
            pu_running=state.pu_running - dec,
        )

    def complete(self, state: DeviceClusterState, rows):
        """Retire the task rows `rows` (int64 indices into [0, Tcap))."""
        done = torch.zeros(self.Tcap, dtype=torch.bool, device=self.device)
        done[rows] = True
        return self._retire(state, done)

    def set_machine(self, state: DeviceClusterState, machine_index: int,
                    enabled: bool):
        """Elastic membership (RegisterResource/DeregisterResource,
        flowscheduler/scheduler.go:134-210): disabling evicts the
        machine's tasks back to the unscheduled pool."""
        me = state.machine_enabled.clone()
        me[machine_index] = enabled
        if enabled:
            return state._replace(machine_enabled=me)
        on_machine = (
            state.live & (state.pu >= 0)
            & (state.pu.clamp(0, self.num_pus - 1) // self.P == machine_index)
        )
        pu_mask = torch.arange(self.num_pus, device=self.device) // self.P == machine_index
        return state._replace(
            machine_enabled=me,
            pu=torch.where(on_machine, -1, state.pu),
            pu_running=torch.where(pu_mask, 0, state.pu_running),
        )

    def steady_round(self, done_u, new_cls, new_job, window_offset,
                     churn_prob: float, arrivals: int) -> dict:
        """One churn round on the device: complete the placed rows whose
        done_u < churn_prob, admit `arrivals` new tasks into the first
        free rows (class and job from new_cls / new_job at each row),
        then schedule with the decode bounded to the configured window
        rotated by window_offset. The draws are tensors (see
        draw_steady). Updates the cluster and returns the round's stats
        as device tensors."""
        state = self.state
        placed = state.live & (state.pu >= 0)
        done = placed & (done_u < torch.full((), churn_prob, dtype=torch.float32,
                                             device=self.device))
        state = self._retire(state, done)
        state, admitted = self._occupy(state, arrivals, new_cls, new_job)
        # steady rounds bound the decode to the configured window; the
        # random offset rotates it over the backlog (or the movers) so
        # no pending task starves
        self.state, stats = self._round(
            state, decode_width=self.decode_width, window_offset=window_offset
        )
        stats["completed"] = done.sum(dtype=_I32)
        stats["admitted"] = admitted
        return stats

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    def add_tasks(self, count, job_ids=None, classes=None) -> None:
        """Admit up to `count` tasks. The admitted count is kept on the
        device in ``last_admitted``: compare it with `count` at a safe
        point to detect an exhausted task pool."""
        jobs = np.zeros(self.Tcap, np.int32)
        cls = np.zeros(self.Tcap, np.int32)
        if job_ids is not None:
            jobs[: len(job_ids)] = job_ids
        if classes is not None:
            cls[: len(classes)] = classes
        self.state, self.last_admitted = self.admit(
            self.state, torch.as_tensor(jobs, device=self.device),
            torch.as_tensor(cls, device=self.device), int(count),
        )

    def complete_tasks(self, rows) -> None:
        rows = np.asarray(rows, np.int64)
        if rows.size and ((rows < 0) | (rows >= self.Tcap)).any():
            raise ValueError(f"task rows must be in [0, {self.Tcap})")
        self.state = self.complete(self.state, torch.as_tensor(rows, device=self.device))

    def set_machine_enabled(self, machine_index: int, enabled: bool) -> None:
        if not 0 <= int(machine_index) < self.M:
            raise ValueError(f"machine_index must be in [0, {self.M})")
        self.state = self.set_machine(self.state, int(machine_index), bool(enabled))

    def round(self) -> dict:
        """One scheduling round over the whole pool; returns un-fetched
        device stats (call fetch_stats() to materialize them)."""
        self.state, stats = self._round(self.state)
        self.last_stats = stats
        return stats

    def run_steady_rounds(self, num_rounds: int, churn_prob: float,
                          arrivals: int, seed: int = 0,
                          generator: Optional[torch.Generator] = None):
        """`num_rounds` chained churn rounds on the device, their draws
        from `generator` (default: a new one on the cluster's device
        seeded with `seed`). Returns stacked stats (device tensors,
        un-fetched)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        rows = []
        for _ in range(int(num_rounds)):
            draws = draw_steady(generator, self.Tcap, self.C, self.J)
            rows.append(self.steady_round(*draws, churn_prob, int(arrivals)))
        stats = {k: torch.stack([r[k] for r in rows]) for k in rows[0]} if rows else {}
        self.last_stats = stats
        return stats

    def run_replay_rounds(self, schedule, seed: int = 0):
        raise _not_ported("trace-replay rounds (run_replay_rounds)", "5c")

    def fetch_stats(self, stats=None) -> dict:
        got = stats if stats is not None else self.last_stats
        out = {k: v.cpu().numpy() for k, v in got.items()}
        if "cost_overflow" in out and bool(np.any(out["cost_overflow"])):
            raise OverflowError(
                "scaled layered costs overflow int32 in a device round "
                "(class_cost_fn values too large for "
                f"n_scale={self.n_scale}); the solve result is invalid"
            )
        return out

    def fetch_state(self) -> dict:
        return {k: v.cpu().numpy() for k, v in self.state._asdict().items()}

    @property
    def num_live_tasks(self) -> int:
        return int(self.state.live.sum())

    @property
    def num_placed_tasks(self) -> int:
        return int((self.state.live & (self.state.pu >= 0)).sum())
