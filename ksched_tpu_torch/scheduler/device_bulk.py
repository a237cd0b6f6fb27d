"""Device-resident bulk scheduling: the whole round on the card.

The ENTIRE cluster state — task table, placements, per-PU occupancy,
machine membership — lives in tensors on one device, and one scheduling
round (capacity refresh -> class census -> transport solve -> flow
decode -> placement apply) is a sequence of tensor operations and one
solve per attempt on that device. Rounds chain on the device. The
host reads two kinds of values, each counted: a solve attempt's
converged flag (solver/layered.py `read_flag`), where it decides the
full-range retry, the grouped stage 1's outcome or the incremental
tier's escalation and the host does not know it yet, and a branch
point's predicates, read in one transfer
(`read_branch`): the stability-aware tier of a hybrid round (one read
a round where the census-drift trigger is on) and the compaction rung
and two-stage test of a grouped solve (one read a solve). These are the
decisions the reference takes with lax.cond on device values; the
cadence counters stay on the host, exact given the escalation flag.
Closed-form rounds read nothing. Stats come back as device tensors;
`fetch_stats` materializes them after the timed region, where the
reference pushes its bindings (cmd/k8sscheduler/scheduler.go:146-187).

The solve is the dense layered transport: `ops.transport_solve` (kernel
B1) with preemption off, `ops.transport_solve_tiered` (kernel B2) for
the continuation-priced re-solve with preemption on; the closed forms
serve single-row, class-degenerate and row-constant rounds. The decode
rank-matches placed tasks to machine grants with integer row gathers
and exclusive in-group ranks, then splits each machine's grant across
its PUs — every count exact in int32.

Modes: preemption off and on (the full tiered re-solve every round),
the stability-aware (two-tier) and three-tier preemption schemes of
steady rounds (`hybrid_round`: incremental rounds with residents
pinned, scoped re-solves over the drifted machines, rare global
re-solves, budgeted incremental attempts escalating to the scoped
tier), realized-cost tracking, and group mode (`GroupSpec`: rows are
caller-defined interchangeability groups with per-group costs and
preference overrides; the exact two-stage decomposition and the
compaction ladder). Steady churn rounds take their random draws as
tensors: `run_steady_rounds(seed=...)` makes the JAX package's own
draws (utils/threefry.py), `draw_steady` others from a
`torch.Generator`. Trace-replay rounds (`run_replay_rounds`) take a
staged window schedule (drivers/trace_replay.py), copied to the device
once per call, and chain its windows there: toggles with evictions,
completions, admissions, then the round.

Graph semantics are those of the host BulkCluster: the same aggregate
topology, pin-on-place accounting with preemption off, keep-arcs
semantics with it on (graph_manager.go:855-888).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..obs.devprof import DeviceSolveCounters
from ..obs.spans import span
from ..solver.layered import (
    COST_SCALE_LIMIT,
    _true,
    choose_eps0,
    converged_on_host,
    pad_geometry,
    read_branch,
    solve_row_constant,
    split_grants_by_class,
    transport_fori,
    transport_fori_tiered,
    validate_alpha,
    validate_job_unsched_cost,
)
from ..utils import threefry
from ..utils.device import resolve_device

_I32 = torch.int32


class DeviceClusterState(NamedTuple):
    live: torch.Tensor  # bool[Tcap]
    cls: torch.Tensor  # int32[Tcap]
    job: torch.Tensor  # int32[Tcap]
    pu: torch.Tensor  # int32[Tcap]; PU index or -1
    pu_running: torch.Tensor  # int32[num_pus]
    machine_enabled: torch.Tensor  # bool[M]
    #: interchangeability group per task (group mode; all-zero otherwise)
    grp: torch.Tensor  # int32[Tcap]


class GroupSpec(NamedTuple):
    """Group metadata on the device (group mode): row g of the transport
    is one interchangeability class of tasks — same task class, same
    escape cost, same per-machine cost profile. Per-task preference arcs
    (graph_manager.go:1229-1264) ride the dense solve this way: tasks
    sharing a preference signature share a row, and the signature's
    preferred machines become per-row cost overrides (pref_w) min'd
    into the class cost row. The host updates them between rounds
    (set_groups)."""

    cls: torch.Tensor  # int32[G] class of each group (census/cost row)
    job: torch.Tensor  # int32[G] job of each group (bookkeeping)
    e: torch.Tensor  # int32[G] task->EC route base cost
    u: torch.Tensor  # int32[G] escape (unsched) cost
    pref_w: torch.Tensor  # int32[G, M] absolute route cost overrides;
    #                       PREF_NONE where the group has no preference


#: pref_w fill for "no preference": large enough never to win the min
#: against a guarded route cost, small enough that min() cannot
#: overflow int32
PREF_NONE = 1 << 30


def _count(idx, n: int):
    """int32[n] counts of the values in idx; entries equal to n (the
    sentinel) land in a spare bucket and are dropped."""
    out = torch.zeros(n + 1, dtype=_I32, device=idx.device)
    out.index_add_(0, idx.long(), torch.ones_like(idx, dtype=_I32))  # kschedlint: index-only (gather index)
    return out[:n]


#: steady rounds whose JAX-package draws the device makes in one pass.
#: A pass is ~170 elementwise launches whatever its size (1.7-2.4 ms at
#: Tcap 65,536 on an H100), more than an incremental round's solve; its
#: int64 temporaries are [DRAW_ROUNDS, 5, Tcap] (42 MB each at 65,536).
DRAW_ROUNDS = 16

#: a staged replay schedule's per-window arrays, in replay_round's
#: argument order
REPLAY_ARRAYS = ("adm_job", "adm_cls", "adm_grp", "adm_n", "done_rows", "done_n",
                 "tog_idx", "tog_on", "tog_n")


def draw_steady(generator: torch.Generator, task_capacity: int,
                range_a: int, range_b: int):
    """One steady round's random draws, made on the generator's device:
    (done_u float32[Tcap] — a row completes if placed and done_u <
    churn_prob; draw_a, draw_b int32[Tcap] in [0, range_a) and [0,
    range_b) — the class and job of the arrival admitted into each free
    row, or in group mode draw_a its index into the arrival map;
    window_offset int32 scalar — the rotation of the decode window)."""
    dev = generator.device
    done_u = torch.rand(task_capacity, generator=generator, device=dev)
    draw_a = torch.randint(0, range_a, (task_capacity,),
                           generator=generator, device=dev, dtype=_I32)
    draw_b = torch.randint(0, range_b, (task_capacity,),
                           generator=generator, device=dev, dtype=_I32)
    window_offset = torch.randint(0, 1 << 30, (), generator=generator,
                                  device=dev, dtype=_I32)
    return done_u, draw_a, draw_b, window_offset


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
        preempt_scope_tau: int = 1,
        preempt_scoped_width: Optional[int] = None,
        preempt_incr_budget: Optional[int] = None,
        track_realized_cost: bool = False,
        num_groups: int = 0,
        active_groups_cap=256,  # an int or a ladder of widths
        refine_waves: int = 8,
        two_stage_eps0: str = "one",
        device="cuda",
    ) -> None:
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
        # Group mode: rows are caller-defined interchangeability groups
        # (GroupSpec) instead of classes or (job, class) pairs.
        self.grouped = num_groups > 0
        if self.grouped:
            if self.per_job:
                raise ValueError(
                    "num_groups and job_unsched_cost are exclusive: group "
                    "escape costs (GroupSpec.u) subsume per-job unsched costs"
                )
            self.G = int(num_groups)
        # Rows the compacted grouped solve can hold: one width, or a
        # ladder of widths of which a round takes the smallest that
        # fits its active-row count.
        if isinstance(active_groups_cap, (int, np.integer)):
            caps = (int(active_groups_cap),)
        else:
            caps = tuple(int(c) for c in active_groups_cap)
        if not caps or any(c < 1 for c in caps):
            raise ValueError("active_groups_cap entries must be >= 1")
        self.active_groups_caps = tuple(sorted({min(c, max(self.G, 1)) for c in caps}))
        self.active_groups_cap = self.active_groups_caps[-1]
        # Price refinement between eps phases (solver/layered.py
        # _price_refine) for the iterative solves.
        self.refine_waves = int(refine_waves)
        # Stage-1 eps schedule of the grouped two-stage solve: "one"
        # (eps0 = 1, budget 256) or "quarter" (n_scale/4, budget 2048).
        if two_stage_eps0 not in ("one", "quarter"):
            raise ValueError("two_stage_eps0 must be 'one' or 'quarter'")
        self.two_stage_eps0 = two_stage_eps0
        # Preemption (keep-arcs semantics, graph_manager.go:855-888):
        # every round re-solves PLACED tasks too; staying is discounted
        # by `continuation_discount`, machine capacity counts total
        # slots. The round emits PLACE / MIGRATE / PREEMPT counts.
        self.preemption = bool(preemption)
        self.continuation_discount = int(continuation_discount)
        # Stability-aware preemption: steady rounds run the incremental
        # core (residents pinned, bounded backlog decode); a re-solve
        # fires every `preempt_every` rounds or when the running-class
        # census drifted by `preempt_drift` task positions (L1) since
        # the last one. With `preempt_global_every` > 0 (three tiers)
        # those re-solves are SCOPED to the machines whose census moved
        # by `preempt_scope_tau` (their residents and the backlog
        # re-solve, the rest stay pinned; movers decoded through a
        # `preempt_scoped_width` window) and a GLOBAL re-solve fires
        # every `preempt_global_every` rounds; `preempt_incr_budget`
        # bounds an incremental attempt, and one that does not converge
        # escalates the round to the scoped tier.
        self.preempt_every = int(preempt_every)
        self.preempt_drift = int(preempt_drift)
        self.preempt_global_every = int(preempt_global_every)
        self.preempt_scope_tau = int(preempt_scope_tau)
        self.preempt_scoped_width = (
            None if preempt_scoped_width is None else int(preempt_scoped_width)
        )
        self.preempt_incr_budget = (
            None if preempt_incr_budget is None else int(preempt_incr_budget)
        )
        if self.preempt_every < 1:
            raise ValueError("preempt_every must be >= 1")
        if self.preempt_drift < 0:
            raise ValueError("preempt_drift must be >= 0")
        if self.preempt_global_every < 0:
            raise ValueError("preempt_global_every must be >= 0")
        if self.preempt_scope_tau < 1:
            raise ValueError("preempt_scope_tau must be >= 1")
        self.hybrid_preempt = self.preemption and (
            self.preempt_every > 1 or self.preempt_drift > 0
        )
        if self.preempt_global_every > 0 and not self.hybrid_preempt:
            raise ValueError(
                "preempt_global_every requires stability-aware "
                "preemption (preempt_every > 1 or preempt_drift > 0)"
            )
        if self.preempt_incr_budget is not None:
            if self.preempt_incr_budget < 1:
                raise ValueError("preempt_incr_budget must be >= 1")
            if self.preempt_global_every <= 0:
                raise ValueError(
                    "preempt_incr_budget requires the three-tier scheme "
                    "(preempt_global_every > 0) — escalation targets the "
                    "scoped tier"
                )
        # Opt-in: price the whole assignment after every hybrid round.
        self.track_realized_cost = bool(track_realized_cost)
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
        # Group mode is heterogeneous (preference overrides).
        jc = self.job_unsched_cost
        self.class_degenerate = (not self.grouped and class_cost_fn is None and (
            jc is None or bool((jc == jc[0]).all())
        ))
        # Row-constant: each row machine-uniform, rows differ — the
        # fractional-knapsack closed form.
        self.row_constant = not self.grouped and self.per_job and class_cost_fn is None
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
        # G*M cells, and always in group mode, the sort-based ranks win.
        self.use_sorted_decode = self.grouped or self.G * self.M >= (1 << 21)
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
        # The hybrid carry: the running-class census at the last
        # re-solve (the drift reference), and the rounds since the last
        # re-solve and the last global one. Both counters start
        # saturated, so the first steady round re-solves (globally):
        # host mutations before it are unseen drift.
        self._hyb_census = torch.zeros((self.M, self.C), dtype=_I32, device=dev)
        self._hyb_k = self.preempt_every - 1
        self._hyb_kg = max(self.preempt_global_every - 1, 0)
        # Benign defaults until set_groups: every group is class 0 /
        # job 0 at the scalar costs with no preferences.
        self.groups = GroupSpec(
            cls=torch.zeros(self.G, dtype=_I32, device=dev),
            job=torch.zeros(self.G, dtype=_I32, device=dev),
            e=torch.full((self.G,), self.ec_cost, dtype=_I32, device=dev),
            u=torch.full((self.G,), self.unsched_cost, dtype=_I32, device=dev),
            pref_w=torch.full((self.G, self.M), PREF_NONE, dtype=_I32, device=dev),
        ) if self.grouped else None
        # host mirror of GroupSpec.cls: grouped admissions derive their
        # tasks' classes without a device read
        self._groups_cls_host = np.zeros(self.G, np.int32) if self.grouped else None
        #: steady-round arrival group map (see set_arrival_groups)
        self._arrival_map = torch.arange(max(self.G, 1), dtype=_I32, device=dev)
        self._arrival_n = max(self.G, 1)
        self.last_stats: Optional[dict] = None
        self.last_admitted = None  # device int32 from the latest add_tasks
        #: per grouped solve, on the host: (rows of the solve — a ladder
        #: width or G —, "two-stage", "fallback" or "full")
        self.last_grouped_path = None
        #: the rounds' bounded attempts and grouped paths, on the
        #: registry current here (obs/devprof.py)
        self.solve_counters = DeviceSolveCounters(grouped_rows=(
            tuple(c for c in self.active_groups_caps if c < self.G) + (self.G,)
            if self.grouped else ()))

    # ------------------------------------------------------------------
    # the round's parts
    # ------------------------------------------------------------------

    def _i32(self, value):
        return torch.full((), value, dtype=_I32, device=self.device)

    def _flag(self, value: bool):
        return torch.full((), bool(value), dtype=torch.bool, device=self.device)

    def census_of(self, state: DeviceClusterState):
        """Per-machine running-class census [M, C] (the vectorized
        WhareMapStats, whare_map_stats.proto:12-18)."""
        M, C = self.M, self.C
        placed = state.live & (state.pu >= 0)
        machine = state.pu.clamp(0, self.num_pus - 1) // self.P
        idx = torch.where(placed, machine * C + state.cls, M * C)
        return _count(idx, M * C).view(M, C)

    def _group_of(self, state):
        """int32[Tcap]: each task's transport row."""
        if self.grouped:
            return state.grp
        return state.job * self.C + state.cls if self.per_job else state.cls

    def _costs(self, state):
        """(cost_eff int32[G, M], w int32[G, M]): the effective per-unit
        place cost and the solve's shifted cost (minus the row's escape
        cost, so the escape column is 0). In group mode the route is
        e_g + cost[cls_g, m] and a preference override wins where
        cheaper: min(EC route, preference arc), the two parallel paths a
        task has in the reference graph (graph_manager.go:1183-1264)."""
        if self.class_cost_fn is not None:
            cost_cm = self.class_cost_fn(self.census_of(state)).to(_I32)
        else:
            cost_cm = None
        if self.grouped:
            gs = self.groups
            if cost_cm is None:
                route = gs.e[:, None].expand(self.G, self.M)
            else:
                route = cost_cm[gs.cls.clamp(0, self.C - 1)] + gs.e[:, None]
            cost_eff = torch.minimum(route, gs.pref_w)
            return cost_eff, cost_eff - gs.u[:, None]
        if cost_cm is None:
            cost_cm = torch.zeros((self.C, self.M), dtype=_I32, device=self.device)
        # row g = j*C + c carries class c's cost row
        cost_gm = cost_cm.repeat(self.J, 1) if self.per_job else cost_cm
        cost_eff = cost_gm + self.ec_cost
        return cost_eff, cost_eff - self.u_row[:, None]

    def _escape_costs(self):
        return self.groups.u if self.grouped else self.u_row

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
        ([W, G], for few groups) or one stable sort (many groups, and
        group mode); its group's cumulative-grant row is an integer row
        gather, so every count stays exact."""
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

    # ---- the grouped solve ----

    def _grouped_solve(self, w, wS, supply, total, col_cap, machine_free,
                       ss_budget):
        """The grouped round's solve (device_bulk.py:722-915 of the
        reference): row compaction to the smallest ladder width that
        fits the active rows, and on each instance either the exact
        two-stage decomposition (cost_fn None, every active row's ground
        profitable, the round not oversubscribed: stage 1 matches the
        sparse preference discounts, stage 2 spreads the rest in closed
        form) or the full solve at alpha 2 with refinement. The branch
        predicates — the active-row count and the two-stage test — are
        one host read, stage 1's flag another. Returns (y int32[G, Mp],
        steps, converged, what the host knows of converged: a bool, or
        None where only the device has it)."""
        Gn, M, n_scale = self.G, self.M, self.n_scale
        gs = self.groups
        log = self.solve_counters
        two_stage = self.class_cost_fn is None
        ground = gs.e - gs.u  # [G] route - escape
        if two_stage:
            D = torch.clamp(ground[:, None] - w, min=0)
            wS1 = self._padded(torch.where(D > 0, -D, 1) * n_scale)
        else:
            wS1 = wS  # unused
        caps = tuple(c for c in self.active_groups_caps if c < Gn)
        act = supply > 0
        preds = []
        if caps:
            preds.append(act.sum(dtype=_I32))
        if two_stage:
            preds.append(((total <= machine_free.sum(dtype=_I32))
                          & ((ground < 0) | ~act).all()).to(_I32))
        got = read_branch(torch.stack(preds)) if preds else []
        n_act = got[0] if caps else Gn
        two_stage_ok = two_stage and bool(got[-1])
        rows = next((c for c in caps if n_act <= c), Gn)
        mfree_total = machine_free.sum(dtype=_I32)

        def solve_full(wS_x, supply_x, budget):
            # full-unit eps start for grouped instances
            eps_full_x = wS_x.abs().amax().clamp(min=1)
            y_f, _pm, s_f, c_f, known = transport_fori(
                wS_x, supply_x, col_cap, budget, alpha=2, refine_waves=8,
                eps0=choose_eps0(n_scale, eps_full_x, supply_x.sum(dtype=_I32),
                                 mfree_total, short=n_scale),
                site="full", log=log,
            )
            return y_f, s_f, c_f, known

        def solve(wS_x, wS1_x, supply_x):
            if not two_stage_ok:
                self.last_grouped_path = (rows, "full")
                log.grouped(rows, "full")
                return solve_full(wS_x, supply_x, ss_budget)
            if self.two_stage_eps0 == "quarter":
                s1_eps0, s1_budget = max(1, n_scale // 4), 2048
            else:
                s1_eps0, s1_budget = 1, 256
            y1, _pm1, s1, conv1, known1 = transport_fori(
                wS1_x, supply_x, col_cap, ss_budget, alpha=2, refine_waves=8,
                eps0=s1_eps0, eps0_budget=s1_budget, eps0_retry=False,
                site="stage1", log=log,
            )
            if converged_on_host(conv1, known1):
                self.last_grouped_path = (rows, "two-stage")
                log.grouped(rows, "two-stage")
                y1r = y1[:, :M]
                left = supply_x - y1r.sum(dim=1, dtype=_I32)
                rem = machine_free - y1r.sum(dim=0, dtype=_I32)
                excl = torch.cumsum(rem, 0, dtype=_I32) - rem
                grants_m = torch.minimum(
                    torch.clamp(left.sum(dtype=_I32) - excl, min=0), rem)
                y_out = y1.clone()
                y_out[:, :M] += split_grants_by_class(grants_m, left)
                y_out[:, self.Mp - 1] = supply_x - y_out[:, :M].sum(dim=1, dtype=_I32)
                return y_out, s1, conv1, True
            # the round's budget is shared: the fallback gets what the
            # exhausted stage 1 left of it
            self.last_grouped_path = (rows, "fallback")
            log.grouped(rows, "fallback")
            fb_budget = ss_budget - min(s1_budget, ss_budget)
            if fb_budget <= 0:
                return y1, s1, conv1, False
            log.discard()
            y_f, s_f, c_f, known = solve_full(wS_x, supply_x, fb_budget)
            return y_f, s1 + s_f, c_f, known

        if rows == Gn:
            return solve(wS, wS1, supply)
        order = torch.sort((~act).to(_I32), stable=True).indices
        sel = order[:rows]
        valid_c = act[sel]
        y_c, steps, conv, known = solve(
            wS[sel], wS1[sel], torch.where(valid_c, supply[sel], 0))
        y = torch.zeros((Gn, self.Mp), dtype=_I32, device=self.device)
        y.index_add_(0, sel, torch.where(valid_c[:, None], y_c, 0))
        return y, steps, conv, known

    def _round_core(self, state: DeviceClusterState, decode_width=None,
                    window_offset=None, supersteps_cap=None):
        """round_core, and what the host knows of the converged flag
        (a bool, or None where only the device has it)."""
        M, P, S, C, Tcap = self.M, self.P, self.S, self.C, self.Tcap
        Gn, num_pus, n_scale = self.G, self.num_pus, self.n_scale
        ss_budget = (self.supersteps if supersteps_cap is None
                     else min(int(supersteps_cap), self.supersteps))
        with span("census"):
            pu_free = torch.where(
                state.machine_enabled.repeat_interleave(P), S - state.pu_running, 0
            )
            machine_free = pu_free.view(M, P).sum(dim=1, dtype=_I32)

            unplaced = state.live & (state.pu < 0)
            if decode_width is None:
                backlog = unplaced.sum(dtype=_I32)
                idx = None  # identity window
                valid, cls_w, job_w, grp_w = unplaced, state.cls, state.job, state.grp
            else:
                backlog, idx, valid = self._window(unplaced, int(decode_width),
                                                   window_offset)
                rows = idx.clamp(0, Tcap - 1)
                cls_w = torch.where(valid, state.cls[rows], C)
                job_w = torch.where(valid, state.job[rows], 0)
                grp_w = torch.where(valid, state.grp[rows], Gn)
            if self.grouped:
                g_w = grp_w
            else:
                g_w = job_w * C + cls_w if self.per_job else cls_w
            g_safe = torch.where(valid, g_w, Gn)
            supply = _count(g_safe, Gn)
            total = supply.sum(dtype=_I32)

        with span("costs"):
            cost_eff, w = self._costs(state)
            # int32 headroom guard: flagged in stats, raised by fetch_stats
            cost_overflow = w.abs().amax() >= COST_SCALE_LIMIT // n_scale
            wS = self._padded(w * n_scale)
            col_cap = self._col_cap(machine_free, total)

        with span("solve"):
            # Cold-started every round: carried prices flatten reduced
            # costs and recreate the identical-cost herding pathology.
            if self.row_constant:
                y = solve_row_constant(w[:, 0], supply, col_cap)
                solve_steps, converged, known = self._i32(0), _true(self.device), True
            elif self.grouped:
                y, solve_steps, converged, known = self._grouped_solve(
                    w, wS, supply, total, col_cap, machine_free, ss_budget)
            else:
                eps_full = wS.abs().amax().clamp(min=1)
                y, _pm, solve_steps, converged, known = transport_fori(
                    wS, supply, col_cap, ss_budget, alpha=self.alpha,
                    eps0=choose_eps0(n_scale, eps_full, total,
                                     machine_free.sum(dtype=_I32)),
                    class_degenerate=self.class_degenerate,
                    refine_waves=self.refine_waves, log=self.solve_counters,
                )
            y_real = y[:, :M]

        # ---- decode: rank-match placed tasks to machine grants ----
        with span("decode"):
            placed_w, pu_abs = self.rank_match_decode(g_safe, y_real, pu_free)
            if idx is None:
                new_pu = torch.where(placed_w, pu_abs, state.pu)
            else:
                # scatter the window's placements back; rows beyond Tcap
                # (invalid or unplaced) land in a spare slot and are dropped
                tgt = torch.where(placed_w, idx, Tcap)
                new_pu = torch.cat([state.pu, state.pu[:1]]).scatter_(
                    0, tgt.long(), pu_abs)[:Tcap]  # kschedlint: index-only (gather index)
            pr_idx = torch.where(placed_w, pu_abs, num_pus)
            pu_running = _count(pr_idx, num_pus) + state.pu_running
            placed_count = placed_w.sum(dtype=_I32)
            # unscheduled counts the WHOLE backlog left pending (solver
            # escapes + rows beyond the decode window)
            placed_cost = (cost_eff * y_real).sum(dtype=_I32)
            if self.per_job or self.grouped:
                # per-row escape pricing needs the whole backlog by row
                g_all = torch.where(unplaced, self._group_of(state), Gn)
                backlog_g = _count(g_all, Gn)
                placed_g = y_real.sum(dim=1, dtype=_I32)
                objective = ((self._escape_costs() * (backlog_g - placed_g)).sum(dtype=_I32)
                             + placed_cost)
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
            if self.grouped:
                stats["active_groups"] = (supply > 0).sum(dtype=_I32)
        return state._replace(pu=new_pu, pu_running=pu_running), stats, known

    def round_core(self, state: DeviceClusterState, decode_width=None,
                   window_offset=None, supersteps_cap=None):
        """One preemption-off scheduling round. decode_width bounds the
        decode to a compacted window of that many unplaced rows (the
        admission-batch bound, k8sclient/client.go:153-193): tasks
        beyond it stay pending; window_offset (int32 scalar) rotates
        which backlog ranks the window covers. decode_width=None decodes
        all Tcap rows (the one-shot round). supersteps_cap bounds the
        round's transport budget below `supersteps` (the grouped
        two-stage fallback gets what stage 1 left of it); a capped solve
        may return converged=False. Returns (state, stats)."""
        state, stats, _known = self._round_core(state, decode_width, window_offset,
                                             supersteps_cap)
        return state, stats

    def round_core_preempt(self, state: DeviceClusterState, decode_width=None,
                           window_offset=None, scope_m=None):
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
        window keep pu=-1 and re-enter the next solve.

        scope_m (bool[M] or None) makes this the SCOPED re-solve of the
        three-tier scheme: residents of out-of-scope machines are pinned
        (they stay, take their machine's capacity, and pay their
        discounted cost in the objective); only residents of in-scope
        machines and the backlog re-solve."""
        M, P, S, C, Tcap = self.M, self.P, self.S, self.C, self.Tcap
        Gn, num_pus, n_scale = self.G, self.num_pus, self.n_scale
        discount = self.continuation_discount
        dev = self.device
        with span("census"):
            enabled_pu = state.machine_enabled.repeat_interleave(P)
            live = state.live
            placed = live & (state.pu >= 0)
            cur_pu = state.pu.clamp(0, num_pus - 1)
            cur_m = torch.where(placed, cur_pu // P, M)  # sentinel M
            g_t = self._group_of(state)

            if scope_m is None:
                in_scope, forced = placed, None
                solve_live = live
                col_cap_m = torch.where(state.machine_enabled, P * S, 0).to(_I32)
            else:
                scope_pad = torch.cat([scope_m, torch.zeros(1, dtype=torch.bool, device=dev)])
                in_scope = placed & scope_pad[cur_m]
                forced = placed & ~in_scope
                solve_live = live & (~placed | in_scope)
                # forced (out-of-scope) stays take their machine's capacity
                F_m = _count(torch.where(forced, cur_m, M), M)
                col_cap_m = torch.where(state.machine_enabled, P * S - F_m, 0).to(_I32)
            g_safe = torch.where(solve_live, g_t, Gn)
            supply = _count(g_safe, Gn)
            total = supply.sum(dtype=_I32)

        with span("costs"):
            cost_eff, w = self._costs(state)
            cost_overflow = (w.abs().amax() + discount) >= COST_SCALE_LIMIT // n_scale

            # resident census per cell [G, M] (in-scope placed tasks)
            cell = torch.where(in_scope, g_t * M + cur_m, Gn * M)
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

        with span("solve"):
            if discount == 0 and self.row_constant:
                y = solve_row_constant(w[:, 0], supply, col_cap)
                solve_steps, converged = self._i32(0), _true(dev)
            elif discount == 0:
                # tiers coincide: the ordinary solve is exact
                y, _pm, solve_steps, converged, _known = transport_fori(
                    wS_hi, supply, col_cap, self.supersteps, alpha=self.alpha,
                    eps0=eps0, class_degenerate=self.class_degenerate,
                    refine_waves=self.refine_waves, log=self.solve_counters,
                )
            else:
                y, _pm, solve_steps, converged, _known = transport_fori_tiered(
                    wS_lo, wS_hi, R_pad, supply, col_cap, self.supersteps,
                    alpha=self.alpha, eps0=eps0, refine_waves=self.refine_waves,
                    log=self.solve_counters,
                )
            y_real = y[:, :M]

        # ---- decode ----
        with span("decode"):
            retained = torch.minimum(y_real, R_real)  # residents kept
            rem = y_real - retained  # grants for movers
            # per-cell resident ranks (row order) via one stable sort
            order = torch.sort(cell, stable=True).indices
            counts = _count(cell, Gn * M + 1)
            starts = torch.cumsum(counts, 0, dtype=_I32) - counts
            rank_sorted = torch.arange(Tcap, dtype=_I32, device=dev) - starts[cell[order]]
            rank_cell = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
            ret_flat = torch.cat([retained.reshape(-1), torch.zeros(1, dtype=_I32, device=dev)])
            stay = in_scope & (rank_cell < ret_flat[cell])
            if forced is not None:
                stay = stay | forced

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
                tgt = torch.where(granted_w, idx, Tcap).long()  # kschedlint: index-only (gather index)
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
                + (self._escape_costs()
                   * (supply - y_real.sum(dim=1, dtype=_I32))).sum(dtype=_I32)
            )
            if forced is not None:
                # forced stays pay their discounted cost, so scoped and
                # global objectives price the same pool
                F_gm = _count(torch.where(forced, g_t * M + cur_m, Gn * M), Gn * M).view(Gn, M)
                objective = (objective + (cost_eff * F_gm).sum(dtype=_I32)
                             - discount * F_gm.sum(dtype=_I32))
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

    def realized_cluster_cost(self, state: DeviceClusterState):
        """The cost of the CURRENT assignment at this state's census:
        every placed task pays its row's effective route cost on its
        machine, every unplaced live task its row's escape cost (int32
        scalar)."""
        cost_eff, _w = self._costs(state)
        on = state.live & (state.pu >= 0)
        m_t = state.pu.clamp(0, self.num_pus - 1) // self.P
        g_c = self._group_of(state).clamp(0, self.G - 1)
        c_task = cost_eff[g_c, m_t]
        esc = self._escape_costs()[g_c]
        return (torch.where(on, c_task, 0).sum(dtype=_I32)
                + torch.where(state.live & ~on, esc, 0).sum(dtype=_I32))

    def hybrid_round(self, state: DeviceClusterState, window_offset):
        """Stability-aware preemption round on the hybrid carry
        (self._hyb_census, _hyb_k, _hyb_kg): the incremental core
        (residents pinned, bounded backlog decode) serves steady rounds;
        a re-solve fires on cadence or when the running census drifted
        past preempt_drift — the full tiered re-solve, or with three
        tiers a scoped one, and a global one every preempt_global_every
        rounds. Only the taken branch runs: the drift test is the one
        branch read, and the cadence counters live on the host. Returns
        (state, stats) and advances the carry."""
        cen = self.census_of(state)
        per_machine = (cen - self._hyb_census).abs().sum(dim=1, dtype=_I32)
        drift = per_machine.sum(dtype=_I32)
        k, kg = self._hyb_k, self._hyb_kg
        do_full = k + 1 >= self.preempt_every
        if self.preempt_drift > 0:
            fire = read_branch((drift >= self.preempt_drift).to(_I32)[None])[0]
            do_full = do_full or bool(fire)
        global_every = self.preempt_global_every
        do_global = kg + 1 >= global_every if global_every > 0 else do_full

        def full():
            s2, st = self.round_core_preempt(state)
            return s2, self.census_of(s2), st

        def scoped():
            # the drift reference re-bases globally after a scoped round
            # too, as after a full one
            s2, st = self.round_core_preempt(
                state, decode_width=self.preempt_scoped_width,
                window_offset=window_offset,
                scope_m=per_machine >= self.preempt_scope_tau)
            return s2, self.census_of(s2), st

        escalated = False
        if do_full or do_global:
            state2, census2, stats = full() if do_global else scoped()
        else:
            state2, stats, known = self._round_core(
                state, decode_width=self.decode_width, window_offset=window_offset,
                supersteps_cap=self.preempt_incr_budget)
            stats.pop("active_groups", None)  # the preempt core has none
            stats["migrated"] = self._i32(0)
            stats["preempted"] = self._i32(0)
            census2 = self._hyb_census
            if (self.preempt_incr_budget is not None
                    and not converged_on_host(stats["converged"], known)):
                # a budget-exhausted incremental attempt is discarded and
                # the round re-runs as a scoped re-solve from the same
                # state; its supersteps stay in the round's count
                self.solve_counters.discard()
                incr_steps = stats["supersteps"]
                state2, census2, stats = scoped()
                stats["supersteps"] = stats["supersteps"] + incr_steps
                escalated = True
        if global_every > 0:
            fired = do_full or do_global or escalated
            self._hyb_kg = 0 if do_global else kg + 1
        else:
            fired = do_full
        self._hyb_k = 0 if fired else k + 1
        self._hyb_census = census2
        stats["full_round"] = self._flag(fired)
        stats["global_round"] = self._flag(do_global if global_every > 0 else fired)
        stats["escalated_round"] = self._flag(escalated)
        stats["census_drift"] = drift
        if self.track_realized_cost:
            stats["realized_cost"] = self.realized_cluster_cost(state2)
        return state2, stats

    def _round(self, state, decode_width=None, window_offset=None):
        core = self.round_core_preempt if self.preemption else self.round_core
        return core(state, decode_width=decode_width, window_offset=window_offset)

    def _occupy(self, state: DeviceClusterState, count, cls, job, grp=None):
        """Occupy the first `count` free rows, row t taking class cls[t],
        job job[t] and group grp[t] (int32[Tcap]; grp None = 0). Returns
        (state, admitted): admitted < count when the task pool is
        exhausted."""
        free_rank = torch.cumsum(~state.live, 0, dtype=_I32) - 1
        newmask = ~state.live & (free_rank < count)
        return state._replace(
            live=state.live | newmask,
            cls=torch.where(newmask, cls, state.cls),
            job=torch.where(newmask, job, state.job),
            grp=torch.where(newmask, 0 if grp is None else grp, state.grp),
            pu=torch.where(newmask, -1, state.pu),
        ), newmask.sum(dtype=_I32)

    def admit(self, state: DeviceClusterState, jobs, classes, count: int,
              groups=None):
        """Occupy the first `count` free rows with the first `count`
        entries of (jobs, classes, groups). Returns (state, admitted)."""
        src = (torch.cumsum(~state.live, 0, dtype=_I32) - 1).clamp(0, self.Tcap - 1)
        return self._occupy(state, count, classes[src], jobs[src],
                            None if groups is None else groups[src])

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
        pu_mask = torch.arange(self.num_pus, dtype=_I32, device=self.device) // self.P == machine_index
        return state._replace(
            machine_enabled=me,
            pu=torch.where(on_machine, -1, state.pu),
            pu_running=torch.where(pu_mask, 0, state.pu_running),
        )

    def steady_round(self, done_u, draw_a, draw_b, window_offset,
                     churn_prob: float, arrivals: int) -> dict:
        """One churn round on the device: complete the placed rows whose
        done_u < churn_prob, admit `arrivals` new tasks into the first
        free rows, then schedule with the decode bounded to the
        configured window rotated by window_offset — through the hybrid
        round in stability-aware preemption mode. An arrival at row t
        takes class draw_a[t] and job draw_b[t]; in group mode it takes
        group arrival_map[draw_a[t]] and that group's class and job. The
        draws are tensors (draw_steady, utils/threefry.py). Updates the
        cluster and returns the round's stats as device tensors."""
        with span("round", path="steady"):
            with span("intake"):
                state = self.state
                placed = state.live & (state.pu >= 0)
                done = placed & (done_u < torch.full((), churn_prob, dtype=torch.float32,
                                                     device=self.device))
                state = self._retire(state, done)
                if self.grouped:
                    new_grp = self._arrival_map[draw_a.long()]  # kschedlint: index-only (gather index)
                    state, admitted = self._occupy(
                        state, arrivals, self.groups.cls[new_grp.long()],  # kschedlint: index-only (gather index)
                        self.groups.job[new_grp.long()], new_grp)  # kschedlint: index-only (gather index)
                else:
                    state, admitted = self._occupy(state, arrivals, draw_a, draw_b)
            self.state, stats = self._bounded_round(state, window_offset)
            stats["completed"] = done.sum(dtype=_I32)
            stats["admitted"] = admitted
            self.solve_counters.settle()
        return stats

    def _bounded_round(self, state: DeviceClusterState, window_offset):
        """The round of a steady or replay round: the decode bounded to
        the configured window, the random offset rotating it over the
        backlog (or the movers) so no pending task starves; the hybrid
        round in stability-aware preemption mode. Returns (state,
        stats)."""
        if self.hybrid_preempt:
            return self.hybrid_round(state, window_offset)
        return self._round(state, decode_width=self.decode_width,
                           window_offset=window_offset)

    def replay_round(self, adm_job, adm_cls, adm_grp, adm_n, done_rows, done_n,
                     tog_idx, tog_on, tog_n, window_offset) -> dict:
        """One trace-replay window on the device (the reference's
        replay_round): its machine toggles, evicting the tasks of the
        machines they disable; its completions; its admissions into the
        first adm_n free rows in ascending order (the rule the stager's
        host mirror predicts); then the bounded round. The arguments are
        one window's row of a staged schedule (drivers/trace_replay.py
        DeviceTraceReplayDriver.stage) as device tensors: the first
        tog_n of tog_idx/tog_on (deduplicated), done_n of done_rows and
        adm_n of adm_job/adm_cls/adm_grp hold; window_offset is an int32
        scalar. Updates the cluster and returns the round's stats as
        device tensors, with `evicted`, `completed` and `admitted`."""
        M, P, Tcap, num_pus = self.M, self.P, self.Tcap, self.num_pus
        dev = self.device
        with span("round", path="replay"):
            with span("intake"):
                state = self.state
                # toggles: invalid slots scatter into a pad slot, cut off after
                valid_t = torch.arange(tog_idx.shape[0], dtype=_I32, device=dev) < tog_n
                idx_t = torch.where(valid_t, tog_idx, M).long()  # kschedlint: index-only (gather index)
                me = torch.cat([state.machine_enabled, state.machine_enabled[:1]]).scatter_(
                    0, idx_t, tog_on)[:M]
                on = state.live & (state.pu >= 0)
                evict = on & ~me[(state.pu.clamp(0, num_pus - 1) // P).long()]  # kschedlint: index-only (gather index)
                pu = torch.where(evict, -1, state.pu)
                on = state.live & (pu >= 0)
                state = state._replace(machine_enabled=me, pu=pu,
                                       pu_running=_count(torch.where(on, pu, num_pus), num_pus))
                # completions
                valid_d = torch.arange(done_rows.shape[0], dtype=_I32, device=dev) < done_n
                idx_d = torch.where(valid_d, done_rows, Tcap).long()  # kschedlint: index-only (gather index)
                done = torch.zeros(Tcap + 1, dtype=torch.bool, device=dev).index_fill_(
                    0, idx_d, True)[:Tcap] & state.live
                state = self._retire(state, done)
                # admissions: row t takes source entry (its rank among the free
                # rows), clipped to the [Amax] sources
                free_rank = torch.cumsum(~state.live, 0, dtype=_I32) - 1
                src = free_rank.clamp(0, adm_job.shape[0] - 1).long()  # kschedlint: index-only (gather index)
                state, admitted = self._occupy(state, adm_n, adm_cls[src], adm_job[src],
                                               adm_grp[src])
            self.state, stats = self._bounded_round(state, window_offset)
            stats["evicted"] = evict.sum(dtype=_I32)
            stats["admitted"] = admitted
            stats["completed"] = done.sum(dtype=_I32)
            self.solve_counters.settle()
        return stats

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    def add_tasks(self, count, job_ids=None, classes=None, groups=None) -> None:
        """Admit up to `count` tasks. The admitted count is kept on the
        device in ``last_admitted``: compare it with `count` at a safe
        point to detect an exhausted task pool. In group mode, `groups`
        assigns each task its interchangeability group; the tasks'
        classes are derived from the group table when omitted and must
        agree with it otherwise."""
        jobs = np.zeros(self.Tcap, np.int32)
        cls = np.zeros(self.Tcap, np.int32)
        grp = np.zeros(self.Tcap, np.int32)
        if job_ids is not None:
            jobs[: len(job_ids)] = job_ids
        if classes is not None:
            cls[: len(classes)] = classes
        if groups is not None:
            if not self.grouped:
                raise ValueError("groups requires num_groups > 0")
            g = np.asarray(groups, np.int32)
            if ((g < 0) | (g >= self.G)).any():
                raise ValueError(
                    f"task group out of range [0, {self.G}): "
                    f"{g.min()}..{g.max()}"
                )
            grp[: len(g)] = g
            derived = self._groups_cls_host[g]
            if classes is None:
                cls[: len(g)] = derived
            else:
                got = np.asarray(classes, np.int32)
                if len(got) < len(g):
                    raise ValueError(
                        f"classes ({len(got)}) shorter than groups "
                        f"({len(g)}): every grouped task needs both"
                    )
                got = got[: len(g)]
                if (got != derived).any():
                    bad = int(np.nonzero(got != derived)[0][0])
                    raise ValueError(
                        f"task {bad}: class {got[bad]} inconsistent with "
                        f"group {g[bad]}'s class {derived[bad]}"
                    )
        dev = self.device
        self.state, self.last_admitted = self.admit(
            self.state, torch.as_tensor(jobs, device=dev),
            torch.as_tensor(cls, device=dev), int(count),
            torch.as_tensor(grp, device=dev),
        )

    def set_groups(self, cls=None, job=None, e=None, u=None, pref_w=None) -> None:
        """Upload group metadata (group mode). Each argument replaces
        that GroupSpec field ([G] arrays; pref_w [G, M], PREF_NONE = no
        preference); omitted fields keep their values."""
        if not self.grouped:
            raise ValueError("set_groups requires num_groups > 0")
        limit = COST_SCALE_LIMIT // self.n_scale
        dev = self.device

        def _vec(name, val, cur, index_range=None):
            if val is None:
                return cur
            a = np.asarray(val, np.int64)  # kschedlint: host-only (host numpy)
            if a.shape != (self.G,):
                raise ValueError(f"{name} must have shape ({self.G},), got {a.shape}")
            if index_range is not None:
                if a.size and ((a < 0) | (a >= index_range)).any():
                    raise ValueError(
                        f"{name} out of range [0, {index_range}): "
                        f"{a.min()}..{a.max()}"
                    )
            elif a.size and np.abs(a).max() >= limit:
                raise OverflowError(
                    f"{name} magnitude {np.abs(a).max()} exceeds the "
                    f"scaled-cost limit {limit}"
                )
            return torch.as_tensor(a.astype(np.int32), device=dev)

        pw = self.groups.pref_w
        if pref_w is not None:
            a = np.asarray(pref_w, np.int64)  # kschedlint: host-only (host numpy)
            if a.shape != (self.G, self.M):
                raise ValueError(
                    f"pref_w must have shape ({self.G}, {self.M}), got {a.shape}"
                )
            real = a[a < PREF_NONE]
            if real.size and np.abs(real).max() >= limit:
                raise OverflowError(
                    f"pref_w magnitude {np.abs(real).max()} exceeds the "
                    f"scaled-cost limit {limit}"
                )
            pw = torch.as_tensor(np.minimum(a, PREF_NONE).astype(np.int32), device=dev)
        self.groups = GroupSpec(
            cls=_vec("cls", cls, self.groups.cls, index_range=self.C),
            job=_vec("job", job, self.groups.job, index_range=self.J),
            e=_vec("e", e, self.groups.e),
            u=_vec("u", u, self.groups.u),
            pref_w=pw,
        )
        if cls is not None:
            self._groups_cls_host = np.asarray(cls, np.int32).copy()

    def set_arrival_groups(self, gids) -> None:
        """Restrict steady-round arrivals to these group ids, drawn
        exactly uniformly over them (the map is padded to [G]; the draw
        indexes only its first len(gids) entries)."""
        if not self.grouped:
            raise ValueError("set_arrival_groups requires group mode")
        g = np.asarray(gids, np.int32)
        if g.size == 0 or ((g < 0) | (g >= self.G)).any():
            raise ValueError("gids must be non-empty, within [0, G)")
        if g.size > self.G:
            raise ValueError("more arrival gids than groups")
        with span("group_table", op="set_arrival_groups"):
            self._arrival_map = torch.as_tensor(np.resize(g, self.G), device=self.device)
        self._arrival_n = int(g.size)

    def complete_tasks(self, rows) -> None:
        rows = np.asarray(rows, np.int64)  # kschedlint: host-only (host numpy)
        if rows.size and ((rows < 0) | (rows >= self.Tcap)).any():
            raise ValueError(f"task rows must be in [0, {self.Tcap})")
        self.state = self.complete(self.state, torch.as_tensor(rows, device=self.device))

    def set_machine_enabled(self, machine_index: int, enabled: bool) -> None:
        if not 0 <= int(machine_index) < self.M:
            raise ValueError(f"machine_index must be in [0, {self.M})")
        self.state = self.set_machine(self.state, int(machine_index), bool(enabled))

    def round(self) -> dict:
        """One scheduling round over the whole pool; returns un-fetched
        device stats (call fetch_stats() to materialize them). In
        stability-aware preemption mode this one-shot round is always a
        full tiered re-solve and resets the hybrid carry."""
        with span("round", path="one-shot"):
            self.state, stats = self._round(self.state)
            if self.hybrid_preempt:
                self._hyb_census = self.census_of(self.state)
                self._hyb_k = 0
                self._hyb_kg = 0
            self.solve_counters.settle()
        self.last_stats = stats
        return stats

    def run_steady_rounds(self, num_rounds: int, churn_prob: float,
                          arrivals: int, seed: int = 0,
                          generator: Optional[torch.Generator] = None):
        """`num_rounds` chained churn rounds on the device. Without a
        generator their draws are the JAX package's for the same seed
        (utils/threefry.py): the host makes the run's keys once, a few
        words a round, and the device draws the bits of each chunk of
        DRAW_ROUNDS rounds as the chunk starts; with one, they come from
        `generator`. Returns stacked stats (device tensors, un-fetched)."""
        R = int(num_rounds)
        # group mode draws an arrival-map index and no job
        range_a, range_b = (self._arrival_n, 1) if self.grouped else (self.C, self.J)
        if generator is None:
            keys, offsets = threefry.steady_keys(seed, R, self.grouped)
            keys = torch.as_tensor(keys, device=self.device)
            offsets = torch.as_tensor(offsets, device=self.device)

            def jax_draws():
                for c in range(0, R, DRAW_ROUNDS):
                    chunk = threefry.steady_draws(keys[c:c + DRAW_ROUNDS], self.Tcap,
                                                  range_a, range_b)
                    for i in range(chunk[0].shape[0]):
                        yield tuple(d[i] for d in chunk) + (offsets[c + i],)

            per_round = jax_draws()
        else:
            per_round = (draw_steady(generator, self.Tcap, range_a, range_b)
                         for _ in range(R))
        rows = [self.steady_round(*d, churn_prob, int(arrivals)) for d in per_round]
        stats = {k: torch.stack([r[k] for r in rows]) for k in rows[0]} if rows else {}
        self.last_stats = stats
        return stats

    def run_replay_rounds(self, schedule, seed: int = 0):
        """Replay `schedule` (a staged window schedule, or a slice of
        its windows: drivers/trace_replay.py DeviceTraceReplayDriver.
        stage) on the device: each of its arrays goes to the device in
        one copy, then its K windows chain there, one replay_round each,
        with no host read beyond those the round kinds make. Window i's
        decode offset is the JAX package's, randint(keys[i], (), 0,
        1 << 30) with keys = split(PRNGKey(seed), K) (utils/threefry.py),
        so a schedule replayed in chunks gets the same offsets only when
        it is chunked alike. Returns stacked stats (device tensors,
        un-fetched)."""
        arrays = [torch.as_tensor(np.asarray(schedule[k]), device=self.device)
                  for k in REPLAY_ARRAYS]
        K = int(arrays[0].shape[0])
        keys = threefry.split(threefry.prng_key(seed), K)
        offsets = torch.as_tensor(threefry.randint(keys, 0, 0, 1 << 30), device=self.device)
        rows = [self.replay_round(*(a[i] for a in arrays), offsets[i]) for i in range(K)]
        stats = {k: torch.stack([r[k] for r in rows]) for k in rows[0]} if rows else {}
        self.last_stats = stats
        return stats

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
        """The state's arrays on the host (a `fetch_state` span: the
        Quincy table's upkeep starts with it)."""
        with span("fetch_state"):
            return {k: v.cpu().numpy() for k, v in self.state._asdict().items()}

    @property
    def num_live_tasks(self) -> int:
        return int(self.state.live.sum(dtype=_I32))

    @property
    def num_placed_tasks(self) -> int:
        return int((self.state.live & (self.state.pu >= 0)).sum(dtype=_I32))
