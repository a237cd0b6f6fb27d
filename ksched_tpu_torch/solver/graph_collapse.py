"""Generic FlowProblem -> dense-transport collapse with automatic CSR
fallback: the policy-dispatch seam of docs/solver_coverage.md, encoded.

The reference serves every policy through one solver seam
(scheduling/flow/placement/solver.go:36-38). The rebuild's production
path is the dense layered transport — exact whenever the graph is
"dense-collapsible" (no binding interior-EC capacities, cost-uniform
resource interiors, no per-task leaf arcs; docs/solver_coverage.md) —
with the CSR backends as the total-generality fallback. Until round 4
the CALLER chose the path; this module encodes the losslessness
predicate so the choice is automatic per solve:

    AutoSolver(csr_backend).solve(problem)
      -> try_collapse(problem): a full structural audit of the flat
         arc arrays. Collapsible -> group tasks into signature rows,
         solve ONE dense transport, reconstruct exact per-arc flows.
         Any refusal (with a reason, kept for observability) -> the
         general-graph backends, unchanged semantics: the mcmf kernel
         when the graph fits it, else the scan-CSR solve.

Soundness: every refusal is conservative (routing to CSR can only cost
time, never correctness), and the collapse itself is exact by the
signature argument of docs/solver_coverage.md — tasks with identical
(escape cost, effective machine-cost row) are interchangeable
commodities, and interior resource trees with a unique path cost fold
into per-column constants + tree capacities (computed as the exact
tree max-flow). Reconstructed flows satisfy conservation and caps by
construction; tests assert objective equality against the CSR oracle.

Collapsible today (the entire non-preempt planned-policy surface):
tasks -> {job unsched aggregator | equivalence classes | machines},
EC -> EC chains that cannot bind, EC -> machine routes, machine
subtrees with a unique per-machine path cost to the sink. Pinned
running tasks (preemption-off) arrive lower-bound-folded and cost
nothing. Keep-mode (preemption-on) graphs carry per-task running arcs
to leaves -> refused -> CSR, as are binding interior capacities and
any structure outside the audited shape.

Performance (round 5): the audit is vectorized end to end —
 * machine subtrees: a level-synchronized BFS over the interior arc
   arrays (owner / depth / path-cost accumulators per node, capacity
   by per-level segment sums) replaces the per-machine Python DFS;
 * EC routes: dense [nE, M] cost tables with (first-arc, next-EC)
   realization pointers replace per-EC column dicts;
 * task rows: one [T, M] numpy min-reduction + byte-view signature
   grouping replaces the per-task loop that iterated every EC route
   dict (measured 46 ms/round of the 57 ms audit at 10k x 1k).
Routes are realized lazily at decode, only for granted cells. The
remaining scalar loops (pin routing, EC chain build) run over plain
Python lists, not numpy scalars. See docs/NOTES.md round-5 section
for the before/after anatomy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.flowgraph import NodeType
from .base import FlowResult, FlowSolver, check_finite_costs, lower_bound_cost

_TASK_TYPES = (
    int(NodeType.ROOT_TASK),
    int(NodeType.SCHEDULED_TASK),
    int(NodeType.UNSCHEDULED_TASK),
)
_BELOW_MACHINE = (
    int(NodeType.NUMA),
    int(NodeType.SOCKET),
    int(NodeType.CACHE),
    int(NodeType.CORE),
    int(NodeType.PU),
)
_BM_SET = frozenset(_BELOW_MACHINE)
_MACH_T = int(NodeType.MACHINE)
_EC_T = int(NodeType.EQUIV_CLASS)
_AGG_T = int(NodeType.JOB_AGGREGATOR)

#: disallowed-cell cost; escape is always cheaper (remapped to a tight
#: bound before the solve to stay inside int32 cost scaling)
_BIG = 1 << 26


@dataclass
class GraphCollapse:
    """Everything needed to solve the dense form and reconstruct.

    Task-side structures are flat arrays parallel to `task_ids` (the
    audited tasks in node-id order); EC routes are dense [nE, M]
    tables realized lazily at decode via (ec_arc, ec_via) pointer
    chains; machine interiors are a (src-sorted arc, child) CSR the
    decode walks only for machines that actually receive grants."""

    supply: np.ndarray  # int32[G]
    col_cap: np.ndarray  # int32[M]
    cost_cm: np.ndarray  # int64[G, M] full placement cost per unit
    row_unsched: np.ndarray  # int64[G] full escape cost per unit
    machine_node: np.ndarray  # int64[M] machine node id per column
    pre_flows: List[Tuple[int, int]]  # folded pinned units (arc, units)
    # interior arcs sorted by (src, arc id): child == -1 -> sink
    dec_src: np.ndarray  # int64[A]
    dec_arc: np.ndarray  # int64[A]
    dec_child: np.ndarray  # int64[A]
    task_ids: np.ndarray  # int64[T] audited task node ids
    rows_tasks: List[np.ndarray]  # per row: indices into task_ids
    esc1: np.ndarray  # int64[T] task->agg arc
    esc2: np.ndarray  # int64[T] agg->sink arc
    # candidate placement arcs, grouped by kind (indices into task_ids)
    mac_t: np.ndarray  # int64[Dm] owning task index
    mac_col: np.ndarray  # int64[Dm] machine column
    mac_arc: np.ndarray  # int64[Dm] arc id
    mac_cost: np.ndarray  # int64[Dm]
    ect_t: np.ndarray  # int64[De] owning task index
    ect_ec: np.ndarray  # int64[De] EC row index
    ect_arc: np.ndarray  # int64[De] task->EC arc id
    ect_cost: np.ndarray  # int64[De]
    # dense EC route tables
    ec_cost_row: np.ndarray  # int64[nE, M] (_BIG = unreachable)
    ec_arc: np.ndarray  # int32[nE, M] first arc on the route
    ec_via: np.ndarray  # int32[nE, M] next EC row, -1 = direct machine


def _refuse(reason: str):
    return None, reason


def _csr_arcs(dec_src, dec_arc, dec_child, v: int):
    """(arc, child) pairs leaving node v in ascending-arc order, from
    the (src, arc)-sorted interior CSR; child == -1 means the sink.
    Shared by the audit's pin router and the decode's tree pushes so
    the two walkers cannot drift."""
    lo = np.searchsorted(dec_src, v)
    hi = np.searchsorted(dec_src, v, side="right")
    return zip(dec_arc[lo:hi].tolist(), dec_child[lo:hi].tolist())


def try_collapse(problem) -> Tuple[Optional[GraphCollapse], str]:
    """Audit a FlowProblem against the dense-collapsibility predicate.

    Returns (collapse, "") when lossless, (None, reason) otherwise.
    Pure host-side numpy over the flat arrays; O(nodes + arcs + G*M).
    """
    nt = np.asarray(problem.node_type)
    excess = np.asarray(problem.excess)
    src = np.asarray(problem.src)
    dst = np.asarray(problem.dst)
    cap = np.asarray(problem.cap)
    cost = np.asarray(problem.cost)
    N = len(nt)

    live = np.nonzero((src > 0) & (cap > 0))[0]
    sinks = np.nonzero(nt == int(NodeType.SINK))[0]
    if len(sinks) != 1:
        return _refuse(f"{len(sinks)} sink nodes")
    sink = int(sinks[0])

    # type-membership lookup tables (nt is small ints >= -1): one
    # fancy-index gather replaces a sort-based np.isin per category
    ntp = (nt + 1).astype(np.int64)
    _n_types = int(ntp.max()) + 2 if len(ntp) else 2
    bm_lut = np.zeros(_n_types, bool)
    bm_lut[[t + 1 for t in _BELOW_MACHINE if t + 1 < _n_types]] = True
    task_lut = np.zeros(_n_types, bool)
    task_lut[[t + 1 for t in _TASK_TYPES if t + 1 < _n_types]] = True

    # arc-wise scalar access below is confined to SMALL loops (pin
    # routing, EC chain build, agg arcs) — numpy scalar extraction is
    # fine there; the big sections are whole-array ops

    # no dict adjacency anywhere: EC arcs are classified with whole-
    # array ops, interior nodes get a sorted-CSR view below
    _ROUTABLE = _BM_SET | {_MACH_T}
    nt_src_live = nt[src[live]]
    out_arcs = live[nt_src_live == _EC_T]

    # interior arcs (live arcs leaving a machine or below-machine
    # node), as a (src, arc-id)-sorted CSR: the pin router and the
    # decode's greedy pushes walk it per node via binary search, in
    # the same ascending-arc order the old adjacency dict preserved
    is_int_src = (nt_src_live == _MACH_T) | bm_lut[ntp[src[live]]]
    int_arcs = live[is_int_src]
    ia_src = src[int_arcs]
    ia_dst = dst[int_arcs]
    _o = np.lexsort((int_arcs, ia_src))
    dec_arc = int_arcs[_o]
    dec_src = ia_src[_o].astype(np.int64)
    dec_child = np.where(dst[dec_arc] == sink, -1, dst[dec_arc]).astype(
        np.int64
    )


    # Positive excess: task nodes (one row unit each) or resource
    # nodes — the latter are lower-bound-FOLDED pinned running tasks
    # (preemption-off pins with cap_lower=1, graph_manager.go:675-720).
    # Folded units are greedily routed to the sink against residual
    # caps before the transport (see _route / pre_flows below); that
    # routing is cost-exact because the audit below proves every
    # leaf->sink path under a machine has one uniform cost, so the
    # greedy path's cost equals any other's. Their cost and flow are
    # charged into the reconstructed solution. Any other excess
    # pattern is outside the audited shape.
    _RESOURCE_TYPES = (_MACH_T,) + _BELOW_MACHINE
    pos = np.nonzero(excess > 0)[0]
    ok_lut = task_lut.copy()
    ok_lut[[t + 1 for t in _RESOURCE_TYPES if t + 1 < _n_types]] = True
    if not ok_lut[ntp[pos]].all():
        return _refuse("positive excess off tasks/resources")
    neg = np.nonzero(excess < 0)[0]
    if len(neg) > 1 or (len(neg) == 1 and int(neg[0]) != sink):
        return _refuse("negative excess off the sink")
    task_mask = task_lut[ntp]
    total_supply = int(excess[(excess > 0) & task_mask].sum())

    # ---- folded pinned units: route each resource node's positive
    # excess to the sink FIRST (the pinned task occupies its slot; the
    # occupancy-reduced interior caps — graph_manager.go:662-667 — mean
    # the unit typically has exactly its own leaf->sink hop left).
    # Machine capacities below are computed on the remaining caps. ----
    pre_flows: List[Tuple[int, int]] = []
    cap_res = cap.astype(np.int64)  # owned copy; pin routing mutates

    def _route(v: int, units: int) -> int:
        routed = 0
        for a, d in _csr_arcs(dec_src, dec_arc, dec_child, v):
            if units == 0:
                break
            if d == -1:  # sink
                take = min(units, int(cap_res[a]))
            elif int(nt[d]) in _ROUTABLE:
                take = _route(d, min(units, int(cap_res[a])))
            else:
                continue
            if take:
                cap_res[a] -= take
                pre_flows.append((a, take))
                units -= take
                routed += take
        return routed

    for v in pos.tolist():
        if int(nt[v]) in _ROUTABLE:
            e = int(excess[v])
            try:
                ok = _route(v, e) == e
            except RecursionError:
                return _refuse("graph too deep for collapse audit")
            if not ok:
                return _refuse(
                    f"resource {v}: folded pinned units exceed capacity"
                )

    # ---- machine subtrees: vectorized level-BFS over interior arcs.
    # Assign every reachable below-machine node an owning column, a
    # depth, and an accumulated path cost; refuse on re-reached nodes
    # (non-tree), non-resource interiors, and non-uniform sink path
    # costs. Capacity is the exact tree max-flow, computed by per-level
    # segment sums from the leaves up. Orphan below-machine nodes (not
    # reachable from any machine) are ignored, exactly as the old DFS
    # never visited them. ----
    machine_nodes = np.nonzero(nt == _MACH_T)[0]
    M = len(machine_nodes)
    if M == 0:
        return _refuse("no machine nodes")

    dst_is_sink = ia_dst == sink
    dst_is_bm = bm_lut[ntp[ia_dst]]
    dst_bad = ~(dst_is_sink | dst_is_bm)

    owner = np.full(N, -1, np.int64)  # owning column per node
    owner[machine_nodes] = np.arange(M)
    depth = np.full(N, -1, np.int64)
    depth[machine_nodes] = 0
    acc = np.zeros(N, np.int64)  # path cost from the machine root

    tree_sel = np.nonzero(dst_is_bm)[0]
    t_src = ia_src[tree_sel]
    t_dst = ia_dst[tree_sel]
    t_cost = cost[int_arcs[tree_sel]].astype(np.int64)
    active = np.ones(len(tree_sel), bool)
    for _ in range(N + 1):
        sel = np.nonzero(active & (depth[t_src] >= 0))[0]
        if not len(sel):
            break
        csrc, cdst = t_src[sel], t_dst[sel]
        already = depth[cdst] >= 0
        if already.any():
            m = int(machine_nodes[owner[csrc[already][0]]])
            return _refuse(
                f"machine {m}: non-tree interior (shared/diamond node)"
            )
        uq, cnt = np.unique(cdst, return_counts=True)
        if (cnt > 1).any():
            dup = uq[cnt > 1][0]
            m = int(machine_nodes[owner[csrc[cdst == dup][0]]])
            return _refuse(
                f"machine {m}: non-tree interior (shared/diamond node)"
            )
        owner[cdst] = owner[csrc]
        depth[cdst] = depth[csrc] + 1
        acc[cdst] = acc[csrc] + t_cost[sel]
        active[sel] = False

    # the audit itself is iterative, but the decode greedily pushes
    # units down the tree with recursive walks (push_down nests
    # tree_cap, so the stack can reach ~2x the tree depth plus the
    # caller's frames) — bound the depth against the REMAINING
    # recursion headroom so a pathological chain refuses here instead
    # of blowing the stack mid-decode (the refusal contract:
    # unauditable -> CSR)
    if len(tree_sel):
        import sys

        frame, live_frames = sys._getframe(), 0
        while frame is not None:
            live_frames += 1
            frame = frame.f_back
        headroom = sys.getrecursionlimit() - live_frames - 100
        if 4 * int(depth.max()) > headroom:
            return _refuse("graph too deep for collapse audit")

    assigned_src = depth[ia_src] >= 0
    bad = np.nonzero(dst_bad & assigned_src)[0]
    if len(bad):
        m = int(machine_nodes[owner[ia_src[bad]].min()])
        return _refuse(f"machine {m}: interior arc to a non-resource node")

    # sink-path uniformity + per-column path cost
    s_sel = np.nonzero(dst_is_sink & assigned_src)[0]
    s_cols = owner[ia_src[s_sel]]
    s_tot = acc[ia_src[s_sel]] + cost[int_arcs[s_sel]]
    col_path = np.zeros(M, np.int64)
    if len(s_sel):
        o = np.argsort(s_cols, kind="stable")
        cs, ts = s_cols[o], s_tot[o]
        starts = np.nonzero(np.r_[True, np.diff(cs) > 0])[0]
        mins = np.minimum.reduceat(ts, starts)
        maxs = np.maximum.reduceat(ts, starts)
        ne = np.nonzero(mins != maxs)[0]
        if len(ne):
            m = int(machine_nodes[cs[starts[ne[0]]]])
            return _refuse(f"machine {m}: non-uniform interior path costs")
        col_path[cs[starts]] = mins

    # exact tree max-flow, leaves up (per-level segment sums)
    aud = int_arcs[assigned_src]
    node_cap = np.zeros(N, np.int64)
    if len(aud):
        a_depth = depth[src[aud]]
        for d in range(int(a_depth.max()), -1, -1):
            s = aud[a_depth == d]
            sd = dst[s]
            contrib = np.where(
                sd == sink, cap_res[s],
                np.minimum(cap_res[s], node_cap[sd]),
            )
            node_cap += np.bincount(
                src[s], weights=contrib, minlength=N
            ).astype(np.int64)
    col_cap = node_cap[machine_nodes]

    # ---- task arcs, classified in one pass ----
    task_ids = np.nonzero(task_mask & (excess > 0))[0]
    T = len(task_ids)
    bad_excess = np.nonzero(excess[task_ids] != 1)[0]
    if len(bad_excess):
        t = int(task_ids[bad_excess[0]])
        return _refuse(f"task {t}: excess {int(excess[t])} != 1")
    tpos = np.full(N, -1, np.int64)
    tpos[task_ids] = np.arange(T)

    ta = live[tpos[src[live]] >= 0]  # all live arcs leaving a task
    ta_dst_t = nt[dst[ta]]
    is_agg = ta_dst_t == _AGG_T
    is_mac = ta_dst_t == _MACH_T
    is_ec = ta_dst_t == _EC_T
    other = ~(is_agg | is_mac | is_ec)
    if other.any():
        a = int(ta[other][0])
        return _refuse(
            f"task {int(src[a])}: arc to node type {int(nt[dst[a]])} "
            "(leaf/keep-mode?)"
        )
    ect_arcs = ta[is_ec]

    # ---- EC routing (chains folded; caps must never bind) ----
    ec_nodes = np.nonzero(nt == _EC_T)[0]
    nE = len(ec_nodes)
    ec_pos = np.full(N, -1, np.int64)
    ec_pos[ec_nodes] = np.arange(nE)
    ec_node_list = ec_nodes.tolist()
    # upper bound on flow through an EC: tasks with an arc into it,
    # PLUS everything its upstream ECs could forward (a chain-fed EC
    # sees the whole upstream inflow — counting only direct task arcs
    # would understate the bound to 0 and wave binding caps through)
    ec_direct_arr = (
        np.bincount(ec_pos[dst[ect_arcs]], minlength=nE)
        if len(ect_arcs) else np.zeros(nE, np.int64)
    )
    # classify every EC-source live arc in one pass
    el_dt = nt[dst[out_arcs]]
    e_isM = el_dt == _MACH_T
    e_isE = el_dt == _EC_T
    e_bad = ~(e_isM | e_isE)
    if e_bad.any():
        a = int(out_arcs[e_bad][0])
        return _refuse(
            f"EC {int(src[a])} arcs to node type {int(nt[dst[a]])}"
        )
    ee = out_arcs[e_isE]  # EC -> EC chain arcs (rare; scalar is fine)
    ec_parents: Dict[int, List[int]] = {e: [] for e in ec_node_list}
    for e_, d_ in zip(src[ee].tolist(), dst[ee].tolist()):
        if d_ in ec_parents:
            ec_parents[d_].append(e_)
    ec_direct = {
        e: int(c) for e, c in zip(ec_node_list, ec_direct_arr.tolist())
    }

    ec_inflow: Dict[int, object] = {}
    _PENDING = object()

    def inflow_of(e: int) -> int:
        got = ec_inflow.get(e)
        if got is _PENDING:
            raise ValueError("EC cycle")
        if got is not None:
            return got
        ec_inflow[e] = _PENDING
        total = ec_direct.get(e, 0) + sum(
            inflow_of(p) for p in ec_parents.get(e, [])
        )
        ec_inflow[e] = total
        return total

    try:
        for e in ec_node_list:
            inflow_of(e)
    except ValueError as err:
        return _refuse(str(err))
    except RecursionError:
        return _refuse("graph too deep for collapse audit")
    inflow_arr = (
        np.array([ec_inflow[e] for e in ec_node_list], np.int64)
        if nE else np.zeros(0, np.int64)
    )

    # dense route tables: per EC row, cheapest cost to every machine
    # column through EC->EC chains, with realization pointers (the
    # first arc + the next EC row, -1 = the arc lands on the machine).
    ec_cost_row = np.full((nE, M), _BIG, np.int64)
    ec_arc = np.full((nE, M), -1, np.int32)
    ec_via = np.full((nE, M), -1, np.int32)

    # EC -> machine arcs: binding checks + scatter, fully vectorized.
    # The arc can only bind if it could carry less than both the
    # feeding tasks AND the machine's own column capacity (which
    # already limits total inflow). The scatter writes costs in
    # DESCENDING order so the last (cheapest) write per cell wins.
    ma = out_arcs[e_isM]
    if len(ma):
        m_e = ec_pos[src[ma]]
        m_col = owner[dst[ma]]
        m_cap = cap[ma].astype(np.int64)
        bound = np.minimum(
            np.minimum(inflow_arr[m_e], total_supply), col_cap[m_col]
        )
        viol = np.nonzero(m_cap < bound)[0]
        if len(viol):
            a = int(ma[viol[0]])
            return _refuse(
                f"EC {int(src[a])}: machine arc cap {int(cap[a])} "
                "can bind"
            )
        m_cost = cost[ma].astype(np.int64)
        o = np.argsort(-m_cost, kind="stable")
        ec_cost_row[m_e[o], m_col[o]] = m_cost[o]
        ec_arc[m_e[o], m_col[o]] = ma[o]

    # EC -> EC chain arcs: binding checks vectorized; the chain fold
    # itself is a memoized DFS with M-vector min-merges per arc (the
    # inflow pass above already proved the chain graph acyclic)
    if len(ee):
        ee_cap = cap[ee].astype(np.int64)
        ee_bound = np.minimum(inflow_arr[ec_pos[src[ee]]], total_supply)
        viol = np.nonzero(ee_cap < ee_bound)[0]
        if len(viol):
            a = int(ee[viol[0]])
            return _refuse(
                f"EC {int(src[a])}: interior EC arc cap {int(cap[a])} "
                "can bind"
            )
        ee_by_row: Dict[int, list] = {}
        for a_, e_, d_ in zip(
            ee.tolist(), ec_pos[src[ee]].tolist(), ec_pos[dst[ee]].tolist()
        ):
            ee_by_row.setdefault(e_, []).append((a_, d_))
        ec_done: Dict[int, bool] = {}

        def build_ec(i: int) -> None:
            if ec_done.get(i):
                return
            ec_done[i] = True
            row, arow, vrow = ec_cost_row[i], ec_arc[i], ec_via[i]
            for a, j in ee_by_row.get(i, []):
                build_ec(j)
                child = ec_cost_row[j]
                cand = int(cost[a]) + child
                better = (child < _BIG) & (cand < row)
                row[better] = cand[better]
                arow[better] = a
                vrow[better] = j

        try:
            for i in range(nE):
                build_ec(i)
        except RecursionError:
            return _refuse("graph too deep for collapse audit")

    # ---- unsched aggregators (lookup over RAW arcs: a fully-drained
    # agg's sink arc has cap 0 and is absent from the live set; it only
    # matters if some task still routes to it — the escape-capacity
    # check below catches that) ----
    agg_sink_of = np.full(N, -1, np.int64)
    agg_mask = nt[src] == _AGG_T
    for a in np.nonzero((src > 0) & agg_mask)[0].tolist():
        g = src[a]
        if int(dst[a]) != sink:
            return _refuse(f"unsched agg {g}: non-sink arc")
        if agg_sink_of[g] >= 0:
            return _refuse(f"unsched agg {g}: multiple sink arcs")
        agg_sink_of[g] = a

    # ---- escapes: exactly one agg arc per task, agg must reach sink ----
    esc_arcs = ta[is_agg]
    esc_t = tpos[src[esc_arcs]]
    if T:
        esc_count = np.bincount(esc_t, minlength=T)
        multi = np.nonzero(esc_count > 1)[0]
        if len(multi):
            return _refuse(
                f"task {int(task_ids[multi[0]])}: two escape arcs"
            )
        none = np.nonzero(esc_count == 0)[0]
        if len(none):
            return _refuse(
                f"task {int(task_ids[none[0]])}: no unsched-aggregator arc"
            )
    esc1 = np.zeros(T, np.int64)
    esc1[esc_t] = esc_arcs
    esc_aggs = dst[esc1] if T else np.zeros(0, np.int64)
    esc2 = agg_sink_of[esc_aggs] if T else np.zeros(0, np.int64)
    no_sink = np.nonzero(esc2 < 0)[0]
    if len(no_sink):
        i = int(no_sink[0])
        return _refuse(
            f"task {int(task_ids[i])}: escape agg {int(esc_aggs[i])} "
            "has no sink arc"
        )
    u_eff = (
        cost[esc1].astype(np.int64) + cost[esc2]
        if T else np.zeros(0, np.int64)
    )

    # escape capacity must not bind (cap >= tasks that may take it)
    if T:
        aggs_u, agg_loads = np.unique(esc_aggs, return_counts=True)
        agg_caps = cap[agg_sink_of[aggs_u]]
        binding = np.nonzero(agg_caps < agg_loads)[0]
        if len(binding):
            i = int(binding[0])
            return _refuse(
                f"unsched agg {int(aggs_u[i])}: sink cap "
                f"{int(agg_caps[i])} < {int(agg_loads[i])} tasks "
                "(binding escape)"
            )

    # ---- effective cost rows: min over direct arcs and EC routes ----
    crow = np.full((T, M), _BIG, np.int64)

    mac_arcs = ta[is_mac]
    mac_t = tpos[src[mac_arcs]]
    mac_col = owner[dst[mac_arcs]]
    mac_cost = cost[mac_arcs].astype(np.int64)
    if len(mac_arcs):
        np.minimum.at(crow, (mac_t, mac_col), mac_cost)

    ect_t = tpos[src[ect_arcs]]
    ect_ec = ec_pos[dst[ect_arcs]]
    ect_cost = cost[ect_arcs].astype(np.int64)
    if len(ect_arcs):
        o = np.argsort(ect_t, kind="stable")
        owner_t = ect_t[o]
        child = ec_cost_row[ect_ec[o]]  # [De, M]
        cand = np.where(child >= _BIG, _BIG, ect_cost[o, None] + child)
        starts = np.nonzero(np.r_[True, np.diff(owner_t) > 0])[0]
        red = np.minimum.reduceat(cand, starts, axis=0)
        rows = owner_t[starts]
        crow[rows] = np.minimum(crow[rows], red)

    crow = np.where(crow >= _BIG, _BIG, crow + col_path[None, :])

    # ---- signature grouping: byte-view unique over (row, escape) ----
    if T:
        key = np.ascontiguousarray(
            np.concatenate([crow, u_eff[:, None]], axis=1)
        )
        kv = key.view(
            np.dtype((np.void, key.shape[1] * key.itemsize))
        ).reshape(T)
        _, first_idx, inv = np.unique(
            kv, return_index=True, return_inverse=True
        )
        supply = np.bincount(inv).astype(np.int32)
        order = np.argsort(inv, kind="stable")
        starts = np.nonzero(np.r_[True, np.diff(inv[order]) > 0])[0]
        rows_tasks = np.split(order, starts[1:])
        row_cost = crow[first_idx]
        row_u = u_eff[first_idx]
    else:
        supply = np.zeros(0, np.int32)
        rows_tasks = []
        row_cost = np.zeros((0, M), np.int64)
        row_u = np.zeros(0, np.int64)

    # disallowed cells: any finite value strictly above every escape
    # cost (escape capacity is unbounded, so such a cell is never
    # taken); keeping it small avoids int32 overflow under the
    # solver's internal n_scale cost scaling
    if T:
        finite = row_cost[row_cost < _BIG]
        hi = int(finite.max()) if finite.size else 0
        disallowed = max(hi, int(row_u.max())) + 1
        row_cost = np.where(row_cost >= _BIG, disallowed, row_cost)

    return GraphCollapse(
        supply=supply,
        col_cap=col_cap.astype(np.int32),
        cost_cm=row_cost,
        row_unsched=row_u,
        machine_node=machine_nodes.astype(np.int64),
        pre_flows=pre_flows,
        dec_src=dec_src, dec_arc=dec_arc.astype(np.int64),
        dec_child=dec_child,
        task_ids=task_ids.astype(np.int64),
        rows_tasks=rows_tasks,
        esc1=esc1,
        esc2=esc2,
        mac_t=mac_t, mac_col=mac_col,
        mac_arc=mac_arcs.astype(np.int64), mac_cost=mac_cost,
        ect_t=ect_t, ect_ec=ect_ec,
        ect_arc=ect_arcs.astype(np.int64), ect_cost=ect_cost,
        ec_cost_row=ec_cost_row, ec_arc=ec_arc, ec_via=ec_via,
    ), ""


class AutoSolver(FlowSolver):
    """The automatic policy-dispatch seam, a three-rung ladder: dense
    transport on `device` when the graph is collapsible, the mcmf
    kernel (solver/mega_solver.py) when a general graph fits its
    budget, the general-graph CSR backend otherwise. Drop-in
    FlowSolver (PlacementSolver/FlowScheduler-compatible); `last_path`
    ("dense" | "mega" | "csr") / `last_refusal` / `last_mega_refusal`
    expose which way each solve went and why.

    `mega` is optional: without it the ladder is dense -> CSR.
    ksched_tpu's ladder also has a sharded multi-chip rung after the
    CSR one; it comes in a later part of the port."""

    def __init__(self, csr_backend: FlowSolver,
                 alpha: int = 8, max_supersteps: int = 1 << 17,
                 mega: Optional[FlowSolver] = None, device="cuda"):
        from ..utils.device import resolve_device

        self.csr = csr_backend
        self.mega = mega
        self.device = resolve_device(device)
        self.alpha = alpha
        self.max_supersteps = max_supersteps
        self.last_path = ""
        self.last_refusal = ""
        self.last_mega_refusal = ""
        self.last_supersteps = 0
        #: solver-interior telemetry of the rung that produced the last
        #: solve (obs/soltel.py); solve_traced publishes it
        self.last_telemetry = None

    def reset(self) -> None:
        self.csr.reset()
        if self.mega is not None:
            self.mega.reset()

    def solve(self, problem) -> FlowResult:
        # rejected before the collapse audit casts costs to integers: the
        # JAX package's AutoSolver lets a NaN cost through to the dense
        # rung, whose objective then comes out as int64's minimum
        check_finite_costs(problem)
        collapse, reason = try_collapse(problem)
        if collapse is None:
            mega = self.mega
            if mega is not None and mega.fits(problem):
                self.last_path, self.last_refusal = "mega", reason
                self.last_mega_refusal = ""
                res = mega.solve(problem)
                self.last_supersteps = getattr(
                    mega, "last_supersteps", res.iterations
                )
                self.last_telemetry = getattr(mega, "last_telemetry", None)
                return res
            self.last_mega_refusal = (
                getattr(mega, "last_refusal", "") if mega is not None
                else "no megakernel attached"
            )
            self.last_path, self.last_refusal = "csr", reason
            res = self.csr.solve(problem)
            ss = getattr(self.csr, "last_supersteps", None)
            self.last_supersteps = (
                ss if ss is not None
                else getattr(self.csr, "last_iterations", 0)
            )
            self.last_telemetry = getattr(self.csr, "last_telemetry", None)
            return res
        self.last_path, self.last_refusal = "dense", ""
        self.last_mega_refusal = ""
        return self._solve_dense(problem, collapse)

    def _solve_dense(self, problem, gc: GraphCollapse) -> FlowResult:
        from .layered import LayeredProblem, LayeredTransportSolver

        if not len(gc.supply):
            # nothing unplaced: only the folded pins' continuation flow
            flow = np.zeros(len(problem.src), np.int64)
            for a, units in gc.pre_flows:
                flow[a] += units
            self.last_supersteps = 0
            self.last_telemetry = None
            return FlowResult(
                flow=flow,
                objective=int(
                    (flow * np.asarray(problem.cost, np.int64)).sum()
                ) + lower_bound_cost(problem),
                iterations=0,
            )
        solver = LayeredTransportSolver(
            alpha=self.alpha, max_supersteps=self.max_supersteps,
            device=self.device,
        )
        res = solver.solve_layered(LayeredProblem(
            supply=gc.supply,
            col_cap=gc.col_cap,
            cost_cm=gc.cost_cm.astype(np.int32),
            unsched_cost=0,
            ec_cost=0,
            row_unsched_cost=gc.row_unsched,
        ))
        self.last_supersteps = res.supersteps
        self.last_telemetry = solver.last_telemetry
        y = np.asarray(res.y, np.int64)

        # ---- exact per-arc flow reconstruction ----
        flow = np.zeros(len(problem.src), np.int64)
        # folded pinned units first: they consumed tree capacity at
        # audit time, so the greedy pushes below see the same residuals
        for a, units in gc.pre_flows:
            flow[a] += units

        # per-task candidate arcs (only granted cells realize a route)
        cands: Dict[int, list] = {}
        for tp, col, a, c in zip(
            gc.mac_t.tolist(), gc.mac_col.tolist(),
            gc.mac_arc.tolist(), gc.mac_cost.tolist(),
        ):
            cands.setdefault(tp, []).append(("d", a, col, c))
        for tp, ei, a, c in zip(
            gc.ect_t.tolist(), gc.ect_ec.tolist(),
            gc.ect_arc.tolist(), gc.ect_cost.tolist(),
        ):
            cands.setdefault(tp, []).append(("e", a, ei, c))
        esc1 = gc.esc1.tolist()
        esc2 = gc.esc2.tolist()
        ec_cost_row, ec_arc, ec_via = gc.ec_cost_row, gc.ec_arc, gc.ec_via
        cap_arr = np.asarray(problem.cap)
        dec_src, dec_arc, dec_child = gc.dec_src, gc.dec_arc, gc.dec_child

        def children_of(v: int):
            return _csr_arcs(dec_src, dec_arc, dec_child, v)

        def tree_cap(v: int) -> int:
            total = 0
            for a, child in children_of(v):
                if child == -1:
                    total += int(cap_arr[a]) - int(flow[a])
                else:
                    total += min(
                        int(cap_arr[a]) - int(flow[a]), tree_cap(child)
                    )
            return total

        def push_down(v: int, units: int) -> None:
            """Distribute `units` down the machine tree (greedy against
            residual throughput; any split is optimal — path costs are
            uniform by audit)."""
            for a, child in children_of(v):
                if units == 0:
                    return
                if child == -1:
                    room = int(cap_arr[a]) - int(flow[a])
                    take = min(units, room)
                    flow[a] += take
                    units -= take
                else:
                    room = min(
                        int(cap_arr[a]) - int(flow[a]), tree_cap(child)
                    )
                    take = min(units, room)
                    if take > 0:
                        push_down(child, take)
                        flow[a] += take
                        units -= take
            assert units == 0, "tree capacity audit violated"

        def realize(tp: int, col: int) -> None:
            """Push task tp's unit along its cheapest route to col."""
            best = None
            for kind, a, x, c in cands.get(tp, []):
                if kind == "d":
                    if x != col:
                        continue
                    cc = c
                else:
                    r = int(ec_cost_row[x, col])
                    if r >= _BIG:
                        continue
                    cc = c + r
                if best is None or cc < best[0]:
                    best = (cc, kind, a, x)
            assert best is not None, (
                "solver granted a disallowed cell — cost "
                "dominance audit violated"
            )
            _, kind, a, x = best
            flow[a] += 1
            if kind == "e":
                e = x
                while True:
                    flow[int(ec_arc[e, col])] += 1
                    nxt = int(ec_via[e, col])
                    if nxt < 0:
                        break
                    e = nxt

        machine_node = gc.machine_node.tolist()
        for g, tasks in enumerate(gc.rows_tasks):
            grants = y[g]
            ti = 0
            task_list = tasks.tolist()
            for col in np.nonzero(grants > 0)[0].tolist():
                n = int(grants[col])
                for _ in range(n):
                    realize(task_list[ti], col)
                    ti += 1
                push_down(machine_node[col], n)
            for tp in task_list[ti:]:  # escapes
                flow[esc1[tp]] += 1
                flow[esc2[tp]] += 1

        objective = int(
            (flow * np.asarray(problem.cost, np.int64)).sum()
        ) + lower_bound_cost(problem)
        return FlowResult(
            flow=flow, objective=objective, iterations=int(res.supersteps)
        )
