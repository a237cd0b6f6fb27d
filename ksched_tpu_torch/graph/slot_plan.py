"""Slot-stable CSR plan: a scatter-maintained entry layout for scan-CSR.

Port of ksched_tpu/graph/slot_plan.py (numpy on the host, the same
numbers), single-card layout only.

The scan-CSR solver (solver/csr_solver.py) needs its doubled residual
entries grouped per source node so segment reductions stay in
cumsum/gather form. `build_csr_plan` derives that grouping by argsorting
the 2M entries by endpoint every time any arc endpoint changes: an
O(M log M) host pass plus a full plan re-upload per endpoint-churn
round. This module replaces the per-round rebuild with a maintained
layout:

- every node owns a contiguous REGION of the entry table, sized to its
  degree high-water mark plus slack, so the segment-boundary tensors
  (`seg_start`/`is_start`/`node_first`/`node_last`/`node_nonempty`)
  change only when a region moves (relocation, below);
- each live arc slot owns two plan rows (forward entry in its src's
  region, backward in its dst's region), assigned when the slot's
  endpoints are set and freed when the arc is removed. Within a region,
  forward rows fill from the FRONT and backward rows from the BACK: the
  discharge allocates a node's excess over its admissible entries front
  to back, and backward rows ahead of forward ones soak pushes into
  bounce-back moves. Liveness is the sign column (`p_sign` in
  {+1, -1, 0}): a dead row has sign 0 and the solver's slot-stable
  residual makes it contribute nothing to any reduction;
- an endpoint change within existing slots mutates O(1) plan rows,
  journaled as dirty positions and shipped as pow2-padded int32 records
  applied by one scatter per plan tensor (`plan_apply`);
- the host mirror of the plan tensors is maintained in place, so the
  full-upload path ships the same values the scatter path maintains
  incrementally, which makes scatter-vs-upload parity checkable bit for
  bit;
- the host argsort and a full plan re-upload survive only on
  `full_build` (slot table reassigned), pow2 bucket growth (n_cap /
  m_cap) and tail-pool exhaustion, all counted on `layout_rebuilds`;
- regions are sized by a per-node-id degree high-water mark that
  persists across layouts (node ids are recycled, and a recycled id's
  new tenant routinely needs more rows than the old one held), plus
  slack for active nodes (+2 rows and 25% of the mark, granted in
  descending churn x region-size order from the pow2 surplus); the mark
  decays toward the live degree at each rebuild;
- a node that out-churns its region is RELOCATED: the surplus after
  the slack grants stays past the packed spans as a tail pool, and
  `_relocate` moves the node's live rows into a 1.25x region, best-fit
  from the dead-span list (returned spans coalesce with neighbours and
  the tail frontier, loose fits split), else fresh tail, in O(degree)
  host writes journaled through the same per-round scatter (the
  segment-boundary tensors get their own record streams). A fresh region
  (an id with no history) is sized by its node TYPE's degree record,
  capped by pool health; a node that empties returns a big span to the
  pool and keeps a small one as recycle insurance.

Entry position 0 is permanently reserved and dead: freed slots'
`inv_order` rows are parked there.

Sharded layout mode (`enable_sharding(D)`, the multi-device rung of
parallel/sharded_solver.py): the table is laid out as D equal-extent
per-shard BLOCKS, block d holding exactly the regions of the nodes
shard d owns (`shard_owner`'s contiguous id ranges; regions were always
allocated in node-id order, so this is the same layout with per-block
bases). Each block reserves its local position 0 as a per-shard dead
slot and keeps its own tail arena and dead-span list, so relocations
stay inside the owner's block and the entry tensors reshape losslessly
to `[D, E/D]`: rank d of the mesh holds block d. Entry order within a
region is unchanged, so a single-device consumer of the same plan
solves bit-identically to the unsharded layout.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import next_pow2

#: int32 columns of one packed plan-row record:
#: (position, arc slot, sign, src, dst)
PLAN_RECORD_COLS = 5
#: int32 columns of one packed inv-order record: (entry index, position)
INV_RECORD_COLS = 2
#: int32 columns of one packed segment-static record (relocations):
#: (position, seg_start value, is_start flag)
SEG_RECORD_COLS = 3
#: int32 columns of one packed node-static record (relocations):
#: (node, node_first, node_last, node_nonempty flag)
NODE_RECORD_COLS = 4

def _pad_records(k: int) -> int:
    from .device_export import pad_record_count

    return pad_record_count(k)


def shard_owner(node_ids, num_nodes: int, num_shards: int) -> np.ndarray:
    """Owner shard per node id: a contiguous range partition, so
    resource subtrees laid out contiguously stay on one shard. The
    sharded solve re-derives the same arithmetic from an arange
    (parallel/sharded_solver.py `node_owner` is this function)."""
    per = -(-num_nodes // max(num_shards, 1))
    return np.minimum(np.asarray(node_ids) // per, num_shards - 1)


def plan_apply(plan, row_rec, inv_rec, seg_rec, node_rec) -> None:  # kschedlint: program=plan_apply
    """Apply a round's packed plan-row, inv-order, segment-static and
    node-static records (int32 tensors on the plan's device) to the ten
    persistent plan tensors `plan` (SlotPlanState.host_args order), in
    place: one `index_copy_` per tensor, indices as int64. Every plan
    tensor is updated in place, as the JAX package donates all ten.
    Records are padded by repeating a real row and the host coalesces
    writes to one position before packing, so duplicate indices carry
    equal values and the scatter order cannot matter."""
    (p_arc, p_sign, p_src, p_dst, seg_start, is_start, inv_order,
     node_first, node_last, node_nonempty) = plan
    pos = row_rec[:, 0].long()  # kschedlint: index-only (index_copy_ positions)
    p_arc.index_copy_(0, pos, row_rec[:, 1].contiguous())
    p_sign.index_copy_(0, pos, row_rec[:, 2].contiguous())
    p_src.index_copy_(0, pos, row_rec[:, 3].contiguous())
    p_dst.index_copy_(0, pos, row_rec[:, 4].contiguous())
    inv_order.index_copy_(0, inv_rec[:, 0].long(), inv_rec[:, 1].contiguous())  # kschedlint: index-only (index_copy_ positions)
    spos = seg_rec[:, 0].long()  # kschedlint: index-only (index_copy_ positions)
    seg_start.index_copy_(0, spos, seg_rec[:, 1].contiguous())
    is_start.index_copy_(0, spos, seg_rec[:, 2] != 0)
    nid = node_rec[:, 0].long()  # kschedlint: index-only (index_copy_ positions)
    node_first.index_copy_(0, nid, node_rec[:, 1].contiguous())
    node_last.index_copy_(0, nid, node_rec[:, 2].contiguous())
    node_nonempty.index_copy_(0, nid, node_rec[:, 3] != 0)


class SlotPlanState:
    """Maintained slot-stable plan over a DeviceGraphState's arc slots.

    Created as an inert shell on every DeviceGraphState; it costs
    nothing until a slot-stable consumer (CsrSolver) calls
    ``ensure_built()``, which flips ``enabled`` and builds the first
    layout. From then on the DeviceGraphState's ``_set_arc`` hooks keep
    it in sync per mutation (O(1) each), and the device-resident mirror
    drains ``drain_records()`` once per round.
    """

    def __init__(self, state) -> None:
        self.state = state  # owning DeviceGraphState
        self.enabled = False
        self.needs_rebuild = True
        self.layout_gen = 0  # bumped per layout (re)build
        self.value_version = 0  # bumped per mutation batch and rebuild
        self.static_version = 0  # bumped per relocation and rebuild
        self.layout_rebuilds = 0  # full rebuilds (telemetry)
        self.region_overflows = 0  # rebuilds forced by tail-pool exhaustion
        self.region_relocations = 0  # regions moved to the tail pool
        # ---- layout (static per layout_gen) --------------------------
        self.entry_cap = 0  # E: padded entry-table extent
        self.region_start: Optional[np.ndarray] = None  # int32[n_cap]
        self.region_cap: Optional[np.ndarray] = None  # int32[n_cap]
        self.seg_start: Optional[np.ndarray] = None  # int32[E]
        self.is_start: Optional[np.ndarray] = None  # bool[E]
        self.node_first: Optional[np.ndarray] = None  # int32[n_cap]
        self.node_last: Optional[np.ndarray] = None  # int32[n_cap]
        self.node_nonempty: Optional[np.ndarray] = None  # bool[n_cap]
        # ---- values (scatter-maintained) -----------------------------
        self.p_arc: Optional[np.ndarray] = None  # int32[E]
        self.p_sign: Optional[np.ndarray] = None  # int32[E] {+1,-1,0}
        self.p_src: Optional[np.ndarray] = None  # int32[E]
        self.p_dst: Optional[np.ndarray] = None  # int32[E]
        self.inv_order: Optional[np.ndarray] = None  # int32[2*m_cap]
        self.pos_fwd: Optional[np.ndarray] = None  # int32[m_cap], -1 unassigned
        self.pos_bwd: Optional[np.ndarray] = None  # int32[m_cap]
        # ---- allocation state ----------------------------------------
        #: forward-row frontier (ascends from region start) and
        #: backward-row frontier (descends from region end)
        self._next_seq: Optional[np.ndarray] = None  # int64[n_cap]
        self._next_back: Optional[np.ndarray] = None  # int64[n_cap]
        self._freed_f: Dict[int, List[int]] = {}  # node -> min-heap (fwd side)
        self._freed_b: Dict[int, List[int]] = {}  # node -> max-heap, negated (bwd side)
        #: live rows currently in each node's region, and the max ever
        #: seen per node id (region sizing input; survives rebuilds)
        self._occ: Optional[np.ndarray] = None  # int64[n_cap]
        self._deg_hwm = np.zeros(0, np.int64)  # kschedlint: host-only (host numpy)
        #: max degree ever seen per node TYPE: sizes the first span of a
        #: fresh region, where the id has no history
        self._type_hwm: Dict[int, int] = {}
        #: cumulative alloc/release events per node id: the slack
        #: rationing weight; persists across rebuilds
        self._churn_ct = np.zeros(0, np.int64)  # kschedlint: host-only (host numpy)
        #: first unassigned tail-pool position per shard block (the
        #: relocation arena; one block covering the whole table in the
        #: default single-shard layout)
        self._tail_next = np.zeros(1, np.int64)  # kschedlint: host-only (host numpy)
        #: abandoned (start, cap) spans per shard block, reused
        #: best-fit before fresh tail
        self._dead_spans: List[List[Tuple[int, int]]] = [[]]
        #: sharded layout mode (enable_sharding): block count, equal
        #: per-block extent (== entry_cap when unsharded), and the
        #: node -> owner-shard map of the current layout
        self._num_shards = 1
        self.block_extent = 0
        self._owner = np.zeros(0, np.int64)  # kschedlint: host-only (host numpy)
        # ---- dirty journal (for the device scatter) ------------------
        self._dirty_pos: set = set()
        self._dirty_inv: set = set()
        self._dirty_seg: set = set()  # relocated segment statics
        self._dirty_node: set = set()  # relocated node statics
        # ---- device caches (non-resident full-upload path) -----------
        self._static_dev: Optional[Tuple] = None  # (key, tensors)
        self._values_dev: Optional[Tuple] = None  # (key, tensors)
        #: bytes device_static / device_args copied to a device, summed
        #: over every upload (the non-resident solve's plan traffic)
        self.uploaded_bytes = 0

    # -- pickling (the warm-restore manifest, runtime/checkpoint.py) -------

    def __getstate__(self):
        # the device caches hold live tensors; they are rebuilt on first
        # use in the restored process
        state = dict(self.__dict__)
        state["_static_dev"] = None
        state["_values_dev"] = None
        return state

    # -- lifecycle ---------------------------------------------------------

    def invalidate(self) -> None:
        """Layout is stale (full_build / pow2 growth / region overflow):
        the next consumer rebuilds from the arrays. Mutation hooks no-op
        until then."""
        self.needs_rebuild = True
        self.clear_pending()

    def ensure_built(self) -> None:
        self.enabled = True
        if self.needs_rebuild:
            self._rebuild()

    def enable_sharding(self, num_shards: int) -> None:
        """Switch every FUTURE layout to the per-shard block form (see
        the module docstring). Idempotent; a shard-count change
        invalidates the layout."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if num_shards != self._num_shards:
            self._num_shards = num_shards
            self.invalidate()

    # -- layout build ------------------------------------------------------

    def _rebuild(self) -> None:
        """Re-derive regions and entry placement from the current arrays
        (vectorized; run only on full_build / growth / overflow)."""
        st = self.state
        n_cap, m_cap = st.n_cap, st.m_cap
        slots = np.fromiter(st._arc_slot.values(), np.int64, len(st._arc_slot))  # kschedlint: host-only (host numpy)
        slots.sort()
        src_l = st.src[slots].astype(np.int64)  # kschedlint: host-only (host numpy)
        dst_l = st.dst[slots].astype(np.int64)  # kschedlint: host-only (host numpy)
        deg = np.bincount(src_l, minlength=n_cap) + np.bincount(dst_l, minlength=n_cap)
        if len(self._deg_hwm) < n_cap:
            self._deg_hwm = np.concatenate(
                [self._deg_hwm, np.zeros(n_cap - len(self._deg_hwm), np.int64)])  # kschedlint: host-only (host numpy)
        if len(self._churn_ct) < n_cap:
            self._churn_ct = np.concatenate(
                [self._churn_ct, np.zeros(n_cap - len(self._churn_ct), np.int64)])  # kschedlint: host-only (host numpy)
        # decay the mark halfway toward the live degree
        hwm = np.maximum(deg, (self._deg_hwm[:n_cap] + deg + 1) // 2)
        self._deg_hwm = hwm
        # reset the per-TYPE degree records to the live peak
        nt = self.state.node_type[:n_cap].astype(np.int64)  # kschedlint: host-only (host numpy)
        self._type_hwm = {
            int(t): int(deg[nt == t].max()) for t in np.unique(nt[deg > 0])
        }
        self._occ = deg.astype(np.int64)  # kschedlint: host-only (host numpy)
        base = hwm.copy()
        churn = self._churn_ct[:n_cap]
        active = hwm > 0
        # slack headroom, granted whole from the pow2 surplus in
        # descending churn x region-size order, after a tail-pool floor
        want = np.where(active, 2 + (hwm >> 2), 0)
        D = self._num_shards
        if D == 1:
            owner = np.zeros(n_cap, np.int64)  # kschedlint: host-only (host numpy)
            need = 1 + int(base.sum())  # kschedlint: disable=int32-reduce -- a host numpy sum
            self.entry_cap = max(2 * m_cap, next_pow2(need))
            if self.entry_cap - need < max(64, self.entry_cap >> 4):
                self.entry_cap = max(
                    2 * m_cap,
                    next_pow2(need + max(64, self.entry_cap >> 4)),
                )
            surplus = self.entry_cap - need
            grantable = max(surplus - max(64, self.entry_cap >> 4), 0)
            slack = want
            if int(want.sum()) > grantable:  # kschedlint: disable=int32-reduce -- a host numpy sum
                order = np.argsort(-(churn * (hwm + 1)), kind="stable")
                fits = np.cumsum(want[order]) <= grantable
                slack = np.zeros_like(want)
                slack[order[fits]] = want[order[fits]]
            self.block_extent = self.entry_cap
        else:
            # equal-extent per-shard blocks, each with its own reserved
            # dead slot (local 0), packed regions and tail arena, sized
            # for the densest shard with full slack wants and floored at
            # (2*m_cap)/D (sharded_entry_extent)
            owner = shard_owner(np.arange(n_cap), n_cap, D)
            full = (base + want).astype(np.int64)  # kschedlint: host-only (host numpy)
            shard_need = np.bincount(owner, weights=full,
                                     minlength=D).astype(np.int64) + 1  # kschedlint: host-only (host numpy)
            max_need = int(shard_need.max())
            Es = next_pow2(max_need)
            if Es - max_need < max(64, Es >> 4):
                Es = next_pow2(max_need + max(64, Es >> 4))
            if (2 * m_cap) % D == 0:
                Es = max(Es, (2 * m_cap) // D)
            self.block_extent = Es
            self.entry_cap = D * Es
            base_sum = np.bincount(owner, weights=base.astype(np.float64),  # kschedlint: host-only (host numpy)
                                   minlength=D).astype(np.int64)  # kschedlint: host-only (host numpy)
            slack = np.zeros_like(want)
            for d in range(D):
                sel = np.flatnonzero(owner == d)
                grantable = max(int(Es - 1 - base_sum[d] - max(64, Es >> 4)), 0)
                wd = want[sel]
                if int(wd.sum()) <= grantable:  # kschedlint: disable=int32-reduce -- a host numpy sum
                    slack[sel] = wd
                else:
                    order = np.argsort(-(churn[sel] * (hwm[sel] + 1)),
                                       kind="stable")
                    fits = np.cumsum(wd[order]) <= grantable
                    slack[sel[order[fits]]] = wd[order[fits]]
        caps = base + slack
        E = self.entry_cap
        Es = self.block_extent
        self._owner = owner
        start = np.empty(n_cap, np.int64)  # kschedlint: host-only (host numpy)
        seg = np.zeros(E, np.int32)
        isstart = np.zeros(E, bool)
        tail0 = np.zeros(D, np.int64)  # kschedlint: host-only (host numpy)
        for d in range(D):
            sel = np.flatnonzero(owner == d) if D > 1 else np.arange(n_cap)
            # each block's local position 0 is its reserved dead slot:
            # its own one-row segment, never allocated
            seg[d * Es] = d * Es
            isstart[d * Es] = True
            if len(sel) == 0:
                # a shard may own no node (D near or above n_cap leaves
                # trailing shards empty): one dead slot and its tail
                tail0[d] = d * Es + 1
                continue
            cd = caps[sel]
            sd = d * Es + 1 + np.concatenate(([0], np.cumsum(cd[:-1])))
            start[sel] = sd
            used_d = int(cd.sum())  # kschedlint: disable=int32-reduce -- a host numpy sum
            seg[d * Es + 1 : d * Es + 1 + used_d] = np.repeat(sd, cd).astype(np.int32)
            isstart[sd[cd > 0]] = True
            tail0[d] = d * Es + 1 + used_d
        self.region_start = start.astype(np.int32)
        self.region_cap = caps.astype(np.int32)
        self.node_first = np.minimum(start, E - 1).astype(np.int32)
        self.node_last = np.minimum(start + caps - 1, E - 1).astype(np.int32)
        self.node_nonempty = caps > 0
        self.seg_start = seg
        self.is_start = isstart
        # entry placement: within a region, forward entries (slot
        # ascending) at the FRONT and backward entries (slot ascending)
        # at the BACK, slack between
        counts_f = np.bincount(src_l, minlength=n_cap)
        cum_f = np.concatenate(([0], np.cumsum(counts_f)[:-1]))
        order_f = np.argsort(src_l, kind="stable")
        gsrc = src_l[order_f]
        rank_f = np.arange(len(slots), dtype=np.int64) - cum_f[gsrc]  # kschedlint: host-only (host numpy)
        pos_f = start[gsrc] + rank_f
        counts_b = np.bincount(dst_l, minlength=n_cap)
        cum_b = np.concatenate(([0], np.cumsum(counts_b)[:-1]))
        order_b = np.argsort(dst_l, kind="stable")
        gdst = dst_l[order_b]
        rank_b = np.arange(len(slots), dtype=np.int64) - cum_b[gdst]  # kschedlint: host-only (host numpy)
        pos_b = start[gdst] + caps[gdst] - counts_b[gdst] + rank_b
        self.p_arc = np.zeros(E, np.int32)
        self.p_sign = np.zeros(E, np.int32)
        self.p_src = np.zeros(E, np.int32)
        self.p_dst = np.zeros(E, np.int32)
        pf = np.full(m_cap, -1, np.int32)
        pb = np.full(m_cap, -1, np.int32)
        sf = slots[order_f]
        sb = slots[order_b]
        pf[sf] = pos_f
        pb[sb] = pos_b
        self.pos_fwd = pf
        self.pos_bwd = pb
        self.p_arc[pos_f] = sf
        self.p_sign[pos_f] = 1
        self.p_src[pos_f] = gsrc
        self.p_dst[pos_f] = st.dst[sf]
        self.p_arc[pos_b] = sb
        self.p_sign[pos_b] = -1
        self.p_src[pos_b] = gdst
        self.p_dst[pos_b] = st.src[sb]
        inv = np.zeros(2 * m_cap, np.int32)
        inv[sf] = pos_f
        inv[m_cap + sb] = pos_b
        self.inv_order = inv
        self._next_seq = start + counts_f
        self._next_back = start + caps - counts_b - 1
        self._freed_f = {}
        self._freed_b = {}
        self._tail_next = tail0
        self._dead_spans = [[] for _ in range(D)]
        self.clear_pending()
        self.layout_gen += 1
        self.value_version += 1
        self.static_version += 1
        self.layout_rebuilds += 1
        self.needs_rebuild = False

    # -- per-mutation hooks (called by DeviceGraphState._set_arc) ----------

    def _alloc(self, node: int, sign: int) -> int:
        """A free position in `node`'s region for a row of `sign`:
        forward rows fill from the region front, backward rows from the
        back. -1 when the region is full and the tail pool cannot house
        a relocated one."""
        self._churn_ct[node] += 1  # failed attempts weigh in too
        nf = int(self._next_seq[node])
        nb = int(self._next_back[node])
        if sign > 0:
            h = self._freed_f.get(node)
            if h and (nf > nb or h[0] < nf):
                pos = heapq.heappop(h)
            elif nf <= nb:
                self._next_seq[node] = nf + 1
                pos = nf
            else:
                if not self._relocate(node):
                    return -1
                return self._alloc(node, sign)
        else:
            h = self._freed_b.get(node)
            if h and (nb < nf or -h[0] > nb):
                pos = -heapq.heappop(h)
            elif nb >= nf:
                self._next_back[node] = nb - 1
                pos = nb
            else:
                if not self._relocate(node):
                    return -1
                return self._alloc(node, sign)
        occ = int(self._occ[node]) + 1
        self._occ[node] = occ
        if occ > self._deg_hwm[node]:
            self._deg_hwm[node] = occ
        t = int(self.state.node_type[node])
        if occ > self._type_hwm.get(t, 0):
            self._type_hwm[t] = occ
        return pos

    def _release(self, node: int, pos: int, sign: int) -> None:
        occ = int(self._occ[node]) - 1
        self._occ[node] = occ
        self._churn_ct[node] += 1
        if occ == 0:
            # an emptied node returns a big span to the pool; a small
            # span stays attached to the id as recycle insurance
            start = int(self.region_start[node])
            cap = int(self.region_cap[node])
            if cap > 16:
                self._return_span(start, cap)
                self.region_cap[node] = 0
                self._next_seq[node] = start
                self._next_back[node] = start - 1
                self._freed_f.pop(node, None)
                self._freed_b.pop(node, None)
                if self.node_nonempty[node]:
                    self.node_nonempty[node] = False
                    self._dirty_node.add(node)
                self.value_version += 1
                self.static_version += 1
            else:
                self._next_seq[node] = start
                self._next_back[node] = start + cap - 1
                self._freed_f.pop(node, None)
                self._freed_b.pop(node, None)
        elif sign > 0:
            heapq.heappush(self._freed_f.setdefault(node, []), pos)
        else:
            heapq.heappush(self._freed_b.setdefault(node, []), -pos)

    def _return_span(self, start: int, cap: int) -> None:
        """Give a span back to its owner block's arena, coalescing with
        adjacent dead spans and with that block's tail frontier (a span
        never straddles a block boundary)."""
        d = start // self.block_extent if self.block_extent else 0
        spans = self._dead_spans[d]
        merged = True
        while merged:
            merged = False
            for i, (s0, c0) in enumerate(spans):
                if s0 + c0 == start:
                    start, cap = s0, c0 + cap
                    spans.pop(i)
                    merged = True
                    break
                if start + cap == s0:
                    cap += c0
                    spans.pop(i)
                    merged = True
                    break
        if start + cap == self._tail_next[d]:
            self._tail_next[d] = start
        else:
            spans.append((start, cap))

    def _claim_span(self, k: int, shard: int = 0) -> Optional[Tuple[int, int]]:
        """A (start, cap) span of >= k rows in `shard`'s block for a
        relocated region: best-fit from the block's dead-span list
        (split when the fit is loose), else the block's fresh tail.
        None when neither fits."""
        spans = self._dead_spans[shard]
        best = -1
        for i, (_s0, c0) in enumerate(spans):
            if c0 >= k and (best < 0 or c0 < spans[best][1]):
                best = i
        if best >= 0:
            s0, c0 = spans.pop(best)
            if c0 - k >= 8:
                spans.append((s0 + k, c0 - k))
                return (s0, k)
            return (s0, c0)
        limit = (shard + 1) * self.block_extent
        if self._tail_next[shard] + k <= limit:
            s0 = int(self._tail_next[shard])
            self._tail_next[shard] += k
            return (s0, k)
        return None

    def _relocate(self, node: int) -> bool:
        """Move `node`'s live rows into a grown region claimed from the
        pool, preserving their relative order, all writes journaled.
        False iff the pool is spent."""
        old_start = int(self.region_start[node])
        old_cap = int(self.region_cap[node])
        occ = int(self._occ[node])
        shard = int(self._owner[node]) if len(self._owner) > node else 0
        want = max(old_cap + max(old_cap >> 2, 2), occ + 2, 4)
        if old_cap == 0:
            # fresh region: the id's TYPE names the new tenant, so its
            # degree record sizes the span, capped by pool health
            pool_left = int(
                (shard + 1) * self.block_extent - self._tail_next[shard]
            ) + sum(c for _, c in self._dead_spans[shard])
            rec = max(
                self._type_hwm.get(int(self.state.node_type[node]), 0),
                int(self._deg_hwm[node]),
            )
            hint = rec + max(2, rec >> 3)
            want = max(want, min(hint, max(pool_left >> 1, 8)))
        placed = self._claim_span(want, shard)
        if placed is None:
            placed = self._claim_span(max(occ + 2, 4), shard)
        if placed is None:
            return False
        new_start, new_cap = placed
        if old_cap > 0:
            self._return_span(old_start, old_cap)
        m_cap = self.state.m_cap
        rows = [
            (pos, int(self.p_sign[pos]))
            for pos in range(old_start, old_start + old_cap)
            if self.p_sign[pos] != 0
        ]
        n_bwd = sum(1 for _, sign in rows if sign < 0)
        wf = new_start
        wb = new_start + new_cap - n_bwd
        for pos, sign in rows:
            slot = int(self.p_arc[pos])
            if sign > 0:
                w = wf
                wf += 1
            else:
                w = wb
                wb += 1
            self._write_row(
                w, slot, sign, int(self.p_src[pos]), int(self.p_dst[pos])
            )
            if sign > 0:
                self.pos_fwd[slot] = w
                self.inv_order[slot] = w
                self._dirty_inv.add(slot)
            else:
                self.pos_bwd[slot] = w
                self.inv_order[m_cap + slot] = w
                self._dirty_inv.add(m_cap + slot)
            self._write_row(pos, 0, 0, 0, 0)
        self.region_start[node] = new_start
        self.region_cap[node] = new_cap
        self.node_first[node] = new_start
        self.node_last[node] = new_start + new_cap - 1
        self.node_nonempty[node] = True
        self._dirty_node.add(node)
        for pos in range(new_start, new_start + new_cap):
            self.seg_start[pos] = new_start
            self.is_start[pos] = pos == new_start
            self._dirty_seg.add(pos)
        self._next_seq[node] = wf
        self._next_back[node] = new_start + new_cap - n_bwd - 1
        self._freed_f[node] = []
        self._freed_b[node] = []
        self.value_version += 1
        self.static_version += 1
        self.region_relocations += 1
        return True

    def _overflow(self) -> None:
        self.region_overflows += 1
        self.invalidate()

    def _write_row(self, pos: int, arc: int, sign: int, src: int, dst: int) -> None:
        self.p_arc[pos] = arc
        self.p_sign[pos] = sign
        self.p_src[pos] = src
        self.p_dst[pos] = dst
        self._dirty_pos.add(pos)

    def slot_assigned(self, slot: int, src: int, dst: int) -> None:
        """A slot gained endpoints: wire its two plan rows."""
        if not self.enabled or self.needs_rebuild:
            return
        pf = self._alloc(src, 1)
        if pf < 0:
            self._overflow()
            return
        pb = self._alloc(dst, -1)
        if pb < 0:
            self._release(src, pf, 1)
            self._overflow()
            return
        m_cap = self.state.m_cap
        self._write_row(pf, slot, 1, src, dst)
        self._write_row(pb, slot, -1, dst, src)
        self.pos_fwd[slot] = pf
        self.pos_bwd[slot] = pb
        self.inv_order[slot] = pf
        self.inv_order[m_cap + slot] = pb
        self._dirty_inv.add(slot)
        self._dirty_inv.add(m_cap + slot)
        self.value_version += 1

    def slot_freed(self, slot: int, src: int, dst: int) -> None:
        """The arc in `slot` was removed: kill its plan rows (sign 0)
        and park its inv entries on the reserved dead position 0."""
        if not self.enabled or self.needs_rebuild:
            return
        pf = int(self.pos_fwd[slot])
        pb = int(self.pos_bwd[slot])
        if pf < 0:  # pragma: no cover - defensive (never assigned)
            return
        m_cap = self.state.m_cap
        self._write_row(pf, 0, 0, 0, 0)
        self._write_row(pb, 0, 0, 0, 0)
        self._release(src, pf, 1)
        self._release(dst, pb, -1)
        self.pos_fwd[slot] = -1
        self.pos_bwd[slot] = -1
        self.inv_order[slot] = 0
        self.inv_order[m_cap + slot] = 0
        self._dirty_inv.add(slot)
        self._dirty_inv.add(m_cap + slot)
        self.value_version += 1

    # -- record packing (device-resident scatter path) ---------------------

    @property
    def has_pending(self) -> bool:
        return bool(
            self._dirty_pos or self._dirty_inv
            or self._dirty_seg or self._dirty_node
        )

    def drain_records(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Pack the dirty plan rows / inv entries / relocated segment
        and node statics into pow2-padded int32 records and clear the
        journal. Positions are coalesced (a position written twice this
        round ships once, final value) and sorted. Empty streams pad
        with an idempotent rewrite of the dead position 0 (rows /
        segment statics) or node 0's current boundary meta."""
        pos = np.sort(np.fromiter(self._dirty_pos, np.int32, len(self._dirty_pos)))
        ents = np.sort(np.fromiter(self._dirty_inv, np.int32, len(self._dirty_inv)))
        segs = np.sort(np.fromiter(self._dirty_seg, np.int32, len(self._dirty_seg)))
        nids = np.sort(np.fromiter(self._dirty_node, np.int32, len(self._dirty_node)))
        kp, ki, ks, kn = len(pos), len(ents), len(segs), len(nids)
        row_rec = np.zeros((_pad_records(kp), PLAN_RECORD_COLS), np.int32)
        if kp:
            row_rec[:kp, 0] = pos
            row_rec[:kp, 1] = self.p_arc[pos]
            row_rec[:kp, 2] = self.p_sign[pos]
            row_rec[:kp, 3] = self.p_src[pos]
            row_rec[:kp, 4] = self.p_dst[pos]
            row_rec[kp:] = row_rec[0]
        inv_rec = np.zeros((_pad_records(ki), INV_RECORD_COLS), np.int32)
        if ki:
            inv_rec[:ki, 0] = ents
            inv_rec[:ki, 1] = self.inv_order[ents]
            inv_rec[ki:] = inv_rec[0]
        else:
            inv_rec[:, 1] = self.inv_order[0]
        seg_rec = np.zeros((_pad_records(ks), SEG_RECORD_COLS), np.int32)
        if ks:
            seg_rec[:ks, 0] = segs
            seg_rec[:ks, 1] = self.seg_start[segs]
            seg_rec[:ks, 2] = self.is_start[segs]
            seg_rec[ks:] = seg_rec[0]
        else:
            seg_rec[:, 1] = self.seg_start[0]
            seg_rec[:, 2] = self.is_start[0]
        node_rec = np.zeros((_pad_records(kn), NODE_RECORD_COLS), np.int32)
        if kn:
            node_rec[:kn, 0] = nids
            node_rec[:kn, 1] = self.node_first[nids]
            node_rec[:kn, 2] = self.node_last[nids]
            node_rec[:kn, 3] = self.node_nonempty[nids]
            node_rec[kn:] = node_rec[0]
        else:
            node_rec[:, 1] = self.node_first[0]
            node_rec[:, 2] = self.node_last[0]
            node_rec[:, 3] = self.node_nonempty[0]
        self.clear_pending()
        return row_rec, inv_rec, seg_rec, node_rec

    def drain_records_sharded(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The per-shard routed form of `drain_records` (sharded layout
        mode): (row_rec [D, K, 5], seg_rec [D, K, 3], inv_rec [Ki, 2],
        node_rec [Kn, 4]). Plan rows and segment statics are grouped by
        OWNER shard (position // block_extent) with block-local
        positions, stacked [D, K, cols] and padded to one shared pow2
        record bucket per stream: a shard with fewer records pads with
        its first real record, an idle shard with an idempotent rewrite
        of its block's dead slot. inv-order and node-boundary records
        stay global (those tensors are replicated)."""
        D = self._num_shards
        Es = self.block_extent
        pos = np.sort(np.fromiter(self._dirty_pos, np.int64, len(self._dirty_pos)))  # kschedlint: host-only (host numpy)
        segs = np.sort(np.fromiter(self._dirty_seg, np.int64, len(self._dirty_seg)))  # kschedlint: host-only (host numpy)
        ents = np.sort(np.fromiter(self._dirty_inv, np.int32, len(self._dirty_inv)))
        nids = np.sort(np.fromiter(self._dirty_node, np.int32, len(self._dirty_node)))

        def route(idx, cols, fill):
            """[D, K, cols] per-shard records from global positions."""
            owner = idx // Es
            counts = np.bincount(owner, minlength=D)
            k = _pad_records(int(counts.max()) if len(idx) else 0)
            rec = np.zeros((D, k, cols), np.int32)
            for d in range(D):
                rec[d] = fill(d)  # idempotent dead-slot pad, whole block
                mine = idx[owner == d]
                kd = len(mine)
                if kd:
                    rec[d, :kd, 0] = (mine - d * Es).astype(np.int32)
                    rec[d, :kd, 1:] = self._row_values(mine, cols)
                    rec[d, kd:] = rec[d, 0]
            return rec

        # a dead slot's row is all zero; its segment static is
        # (own position, start flag)
        row_rec = route(pos, PLAN_RECORD_COLS,
                        lambda d: np.zeros(PLAN_RECORD_COLS, np.int32))
        seg_rec = route(segs, SEG_RECORD_COLS,
                        lambda d: np.array([0, d * Es, 1], np.int32))
        ki, kn = len(ents), len(nids)
        inv_rec = np.zeros((_pad_records(ki), INV_RECORD_COLS), np.int32)
        if ki:
            inv_rec[:ki, 0] = ents
            inv_rec[:ki, 1] = self.inv_order[ents]
            inv_rec[ki:] = inv_rec[0]
        else:
            inv_rec[:, 1] = self.inv_order[0]
        node_rec = np.zeros((_pad_records(kn), NODE_RECORD_COLS), np.int32)
        if kn:
            node_rec[:kn, 0] = nids
            node_rec[:kn, 1] = self.node_first[nids]
            node_rec[:kn, 2] = self.node_last[nids]
            node_rec[:kn, 3] = self.node_nonempty[nids]
            node_rec[kn:] = node_rec[0]
        else:
            node_rec[:, 1] = self.node_first[0]
            node_rec[:, 2] = self.node_last[0]
            node_rec[:, 3] = self.node_nonempty[0]
        self.clear_pending()
        return row_rec, seg_rec, inv_rec, node_rec

    def _row_values(self, idx: np.ndarray, cols: int) -> np.ndarray:
        if cols == PLAN_RECORD_COLS:
            return np.stack(
                [self.p_arc[idx], self.p_sign[idx], self.p_src[idx], self.p_dst[idx]],
                axis=1,
            )
        return np.stack(
            [self.seg_start[idx], self.is_start[idx].astype(np.int32)], axis=1)

    def clear_pending(self) -> None:
        self._dirty_pos.clear()
        self._dirty_inv.clear()
        self._dirty_seg.clear()
        self._dirty_node.clear()

    # -- materialization ---------------------------------------------------

    def host_args(self) -> Tuple:
        """The plan tensors as host arrays, in `_solve_mcmf` positional
        order: the full-upload materialization the scatter path must
        match bit for bit."""
        self.ensure_built()
        return (
            self.p_arc, self.p_sign, self.p_src, self.p_dst,
            self.seg_start, self.is_start, self.inv_order,
            self.node_first, self.node_last, self.node_nonempty,
        )

    def device_static(self, device) -> Tuple:
        """The segment/node boundary tensors on `device`, cached per
        (layout_gen, static_version, device): uploaded once per layout
        and re-shipped only when a relocation moved a region."""
        self.ensure_built()
        key = (self.layout_gen, self.static_version, str(device))
        if self._static_dev is None or self._static_dev[0] != key:
            self._static_dev = (key, tuple(
                torch.as_tensor(x, device=device)
                for x in (
                    self.seg_start, self.is_start,
                    self.node_first, self.node_last, self.node_nonempty,
                )
            ))
            self.uploaded_bytes += self.static_nbytes()
        return self._static_dev[1]

    def static_nbytes(self) -> int:
        return int(
            self.seg_start.nbytes + self.is_start.nbytes
            + self.node_first.nbytes + self.node_last.nbytes
            + self.node_nonempty.nbytes
        )

    def values_nbytes(self) -> int:
        return int(
            self.p_arc.nbytes + self.p_sign.nbytes
            + self.p_src.nbytes + self.p_dst.nbytes + self.inv_order.nbytes
        )

    def device_args(self, device) -> Tuple:
        """The full plan as tensors on `device` in `_solve_mcmf` order,
        cached by (layout_gen, value_version, device): a clean round
        re-uses the previous upload; a dirty round re-ships the host
        arrays wholesale (the non-resident path; the device-resident
        mirror scatters records instead)."""
        self.ensure_built()
        key = (self.layout_gen, self.value_version, str(device))
        if self._values_dev is None or self._values_dev[0] != key:
            self._values_dev = (key, tuple(
                torch.as_tensor(x, device=device)
                for x in (self.p_arc, self.p_sign, self.p_src, self.p_dst,
                          self.inv_order)
            ))
            self.uploaded_bytes += self.values_nbytes()
        p_arc, p_sign, p_src, p_dst, inv = self._values_dev[1]
        seg, isstart, first, last, nonempty = self.device_static(device)
        return (p_arc, p_sign, p_src, p_dst, seg, isstart, inv,
                first, last, nonempty)

    # -- invariants (tests / debug) ----------------------------------------

    def check_invariants(self) -> None:
        """Verify the maintained layout is internally consistent with
        the owning DeviceGraphState (O(E)). Raises a structured
        `runtime.integrity.IntegrityError` (an AssertionError
        subclass)."""
        from ..runtime.integrity import IntegrityError

        try:
            self._check_invariants_impl()
        except IntegrityError:
            raise
        except AssertionError as e:
            raise IntegrityError(f"slot-plan invariant violated: {e}",
                                 array="slot_plan") from e

    def _check_invariants_impl(self) -> None:
        st = self.state
        assert not self.needs_rebuild, "plan not built"
        live = sorted(st._arc_slot.values())
        seen = set()
        for slot in live:
            pf, pb = int(self.pos_fwd[slot]), int(self.pos_bwd[slot])
            s, d = int(st.src[slot]), int(st.dst[slot])
            assert pf > 0 and pb > 0, f"slot {slot} unassigned"
            assert pf not in seen and pb not in seen, f"slot {slot} aliases a row"
            seen.update((pf, pb))
            rs, rc = int(self.region_start[s]), int(self.region_cap[s])
            assert rs <= pf < rs + rc, f"fwd row of slot {slot} outside src region"
            assert int(self.seg_start[pf]) == rs, (
                f"fwd row of slot {slot} carries a stale segment start")
            rs, rc = int(self.region_start[d]), int(self.region_cap[d])
            assert rs <= pb < rs + rc, f"bwd row of slot {slot} outside dst region"
            assert int(self.seg_start[pb]) == rs, (
                f"bwd row of slot {slot} carries a stale segment start")
            assert (
                self.p_arc[pf] == slot and self.p_sign[pf] == 1
                and self.p_src[pf] == s and self.p_dst[pf] == d
            ), f"fwd row of slot {slot} stale"
            assert (
                self.p_arc[pb] == slot and self.p_sign[pb] == -1
                and self.p_src[pb] == d and self.p_dst[pb] == s
            ), f"bwd row of slot {slot} stale"
            assert int(self.inv_order[slot]) == pf
            assert int(self.inv_order[st.m_cap + slot]) == pb
        n_live_rows = int((self.p_sign != 0).sum())  # kschedlint: disable=int32-reduce -- a host numpy sum
        assert n_live_rows == 2 * len(live), (
            f"{n_live_rows} live plan rows for {len(live)} live slots")
        assert self.p_sign[0] == 0, "reserved position 0 must stay dead"
        occ = np.bincount(self.p_src[self.p_sign != 0], minlength=st.n_cap)
        if not np.array_equal(occ, self._occ[: st.n_cap]):
            from ..runtime.integrity import bounded_diff

            # raised as the structured error itself, so its indices,
            # expected and found values stay machine-readable
            raise bounded_diff("plan_occupancy", self._occ[: st.n_cap], occ)
        assert (self._deg_hwm[: st.n_cap] >= occ).all(), (
            "degree high-water mark fell below live occupancy")
        block_limits = (np.arange(self._num_shards, dtype=np.int64) + 1) * self.block_extent  # kschedlint: host-only (host numpy)
        assert (self._tail_next <= block_limits).all(), (
            "a tail pool overran its shard block")
        # the fwd-front/bwd-back split within every region
        fpos = np.flatnonzero(self.p_sign == 1).astype(np.int64)  # kschedlint: host-only (host numpy)
        bpos = np.flatnonzero(self.p_sign == -1).astype(np.int64)  # kschedlint: host-only (host numpy)
        maxf = np.full(st.n_cap, -1, np.int64)  # kschedlint: host-only (host numpy)
        np.maximum.at(maxf, self.p_src[fpos], fpos)
        minb = np.full(st.n_cap, self.entry_cap, np.int64)  # kschedlint: host-only (host numpy)
        np.minimum.at(minb, self.p_src[bpos], bpos)
        assert (maxf < minb).all(), "a backward row precedes a forward row in its region"
        # held regions are pairwise disjoint and inside [1, tail)
        starts = self.region_start.astype(np.int64)  # kschedlint: host-only (host numpy)
        caps64 = self.region_cap.astype(np.int64)  # kschedlint: host-only (host numpy)
        held = caps64 > 0
        order = np.argsort(starts[held], kind="stable")
        lo = starts[held][order]
        hi = lo + caps64[held][order]
        if lo.size:
            assert (hi[:-1] <= lo[1:]).all(), "regions overlap"
            # every held region lives inside its OWNER's block, past the
            # block's reserved dead slot and under its tail frontier
            # (one block is the whole table when unsharded)
            own = self._owner[np.flatnonzero(held)]
            s_h = starts[held]
            e_h = s_h + caps64[held]
            assert (s_h >= own * self.block_extent + 1).all(), (
                "a region precedes its block's reserved dead slot")
            assert (e_h <= self._tail_next[own]).all(), (
                "a region lies outside the packed/tail extent")
        for node in np.flatnonzero(held):
            assert int(self.node_first[node]) == int(starts[node])
            assert int(self.node_last[node]) == int(starts[node] + caps64[node] - 1)


from ..analysis.program_registry import declare_programs as _declare_programs  # noqa: E402

_declare_programs(__name__, "plan_apply")
