"""Flat-array graph state: the replacement for the DIMACS wire.

Where the reference streams DIMACS text to a solver subprocess
(scheduling/flow/placement/solver.go:92-123), this build keeps the
flow network as flat structure-of-arrays buffers whose row indices ARE
the flow-graph node ids (dense + recycled, see graph/flowgraph.py). A
full build converts the host graph once; afterwards the per-round change
journal (graph/changes.py) is scattered into the arrays in place, so the
cost of preparing a round's solve tracks the delta, not the graph — the
same property the reference gets from Flowlessly's incremental daemon
mode.

Arrays are padded to power-of-two extents so the cluster's growth
changes shapes rarely.

Two consumers read the per-round mutations:

- ``problem()`` materializes the lower-bound-folded host FlowProblem,
  rebuilding only the array groups a journal entry actually touched
  since the last materialize (clean rounds return the cached object);
- ``DeviceResidentState`` mirrors the folded arrays as persistent
  tensors on the card: the round's dirty slots/nodes are packed on the
  host into flat int32 delta records and applied by one scatter per
  array (`delta_apply`), so after the initial full upload only
  delta-sized records cross the host/device boundary. The mirror is
  rebuilt only when a pow2 bucket grows or `full_build` reassigns the
  slot table.

In sharded plan mode (`DeviceResidentState.enable_sharded_plan`, the
multi-device rung of parallel/) each rank of the mesh holds its own
`[Es]` block of the six entry-shaped plan tensors and the whole of the
replicated ones, and a round's plan records are routed to their owner
ranks.

Port of ksched_tpu/graph/device_export.py.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .changes import AddNodeChange, Change, ChangeArcChange, NewArcChange, RemoveNodeChange
from .flowgraph import FlowGraph
from ..utils import next_pow2


@dataclass
class FlowProblem:
    """A min-cost max-flow instance in flat arrays.

    Row 0 of the node arrays is a padding row (graph node ids start at 1).
    Arc lower bounds are already folded into ``excess`` via the standard
    transformation; ``flow_offset`` holds the folded lower bound per arc so
    decoded flows can be restored (decoded_flow = solver_flow + flow_offset).
    """

    num_nodes: int  # dense extent including padding row
    excess: np.ndarray  # int64[N] supply(+)/demand(-) after lower-bound fold
    node_type: np.ndarray  # int8[N] NodeType, -1 for invalid rows
    src: np.ndarray  # int32[M]
    dst: np.ndarray  # int32[M]
    cap: np.ndarray  # int32[M] residual upper bound after lower-bound fold
    cost: np.ndarray  # int32[M]
    flow_offset: np.ndarray  # int32[M] folded lower bounds
    num_arcs: int  # live arc slots (<= len(src))
    #: slot-stable CSR plan handle (graph/slot_plan.SlotPlanState) when
    #: the problem came from a DeviceGraphState; None for plain
    #: array-built problems (bulk, tests) — consumers that don't know
    #: about it (cpu_ref, ell, mega) just ignore it
    plan: object = None
    #: cheap endpoint-structure generation key
    #: (state uid, rebuild_count, n_cap, m_cap, endpoint_gen): two
    #: problems with equal keys have identical arc endpoints, so
    #: solver plan caches can skip their O(M) endpoint scans entirely
    #: on clean rounds (None = unknown, fall back to comparing arrays)
    plan_key: object = None

    @property
    def total_supply(self) -> int:
        return int(self.excess[self.excess > 0].sum())  # kschedlint: disable=int32-reduce -- a host numpy sum


def pad_problem(problem: FlowProblem, n_cap: int, m_cap: int) -> FlowProblem:
    """Zero-pad a FlowProblem into a LARGER pow2 shape bucket (the
    multi-tenant lane-alignment helper, tenancy/batch.py).

    Padding rows are inert by construction: pad nodes carry zero excess
    and node_type -1, pad arc slots are (0, 0) self-loops at node 0
    with zero cap/cost, whose forward AND backward residuals are zero —
    they can never push, relabel, or absorb prefix allocation, so the
    real prefix of the solved flow is unchanged by the padding.

    One caveat the tenancy layer documents and tests: the general-graph
    solvers pre-scale costs by ``num_nodes`` for eps=1 exactness, so a
    padded problem is a DIFFERENT (equally exact) solve than the
    unpadded one — bit-parity holds between runs that pad identically
    (a lane vs the same lane solved alone at the same bucket), not
    between a padded and an unpadded solve. Bucket assignment is
    therefore a per-tenant property (its own caps + a static floor),
    never a function of which co-tenants happen to share the process.
    """
    n0, m0 = problem.num_nodes, len(problem.src)
    if n_cap < n0 or m_cap < m0:
        raise ValueError(
            f"pad_problem cannot shrink: ({n0}, {m0}) -> ({n_cap}, {m_cap})"
        )
    if n_cap == n0 and m_cap == m0:
        return problem

    def pad_to(arr, size, fill=0):
        out = np.full(size, fill, dtype=arr.dtype)
        out[: len(arr)] = arr
        return out

    return FlowProblem(
        num_nodes=n_cap,
        excess=pad_to(problem.excess, n_cap),
        node_type=pad_to(problem.node_type, n_cap, fill=-1),
        src=pad_to(problem.src, m_cap),
        dst=pad_to(problem.dst, m_cap),
        cap=pad_to(problem.cap, m_cap),
        cost=pad_to(problem.cost, m_cap),
        flow_offset=pad_to(problem.flow_offset, m_cap),
        num_arcs=problem.num_arcs,
        plan=None,  # slot-stable plans do not survive re-padding
        plan_key=(
            ("padded", problem.plan_key, n_cap, m_cap)
            if problem.plan_key is not None
            else None
        ),
    )


_STATE_UIDS = itertools.count()


class DeviceGraphState:
    """Maintains the padded flat arrays + the (src, dst) → arc-slot map.

    ``full_build`` constructs arrays from a host FlowGraph; ``apply_changes``
    scatters a change journal into them. Freed arc slots are recycled.
    """

    def __init__(self) -> None:
        self.n_cap = 0  # padded node extent
        self.m_cap = 0  # padded arc extent
        self.excess: Optional[np.ndarray] = None
        self.node_type: Optional[np.ndarray] = None
        self.src: Optional[np.ndarray] = None
        self.dst: Optional[np.ndarray] = None
        self.cap: Optional[np.ndarray] = None
        self.low: Optional[np.ndarray] = None
        self.cost: Optional[np.ndarray] = None
        #: per-node lower-bound fold contribution, maintained
        #: incrementally as arc lows change: folded excess ==
        #: ``excess + fold`` (replaces the O(M) scatter fold the old
        #: problem() ran every round)
        self.fold: Optional[np.ndarray] = None
        self._arc_slot: Dict[Tuple[int, int], int] = {}
        self._free_slots: List[int] = []
        self._num_slots = 0
        self.num_nodes = 0
        self.generation = 0  # bumped when padded extents change (recompile signal)
        #: bumped by full_build only: the slot table was reassigned, so
        #: any device mirror of the arc arrays is wholesale invalid
        #: (growth keeps slots stable and is signaled by n_cap/m_cap)
        self.rebuild_count = 0
        #: bumped whenever some slot's (src, dst) actually changes —
        #: cap/cost-only journals leave it alone, so solver plan caches
        #: keyed on plan_key() skip their endpoint scans on clean rounds
        self.endpoint_gen = 0
        self._uid = next(_STATE_UIDS)
        #: slot-stable CSR plan (graph/slot_plan.py): an inert shell
        #: until a slot-stable consumer calls plan.ensure_built(); after
        #: that the _set_arc hooks keep it in sync per endpoint change
        from .slot_plan import SlotPlanState

        self.plan = SlotPlanState(self)
        # -- mutation tracking ------------------------------------------
        # The problem() cache needs only "did anything in this group
        # change" booleans; the device-resident mirror needs the exact
        # touched slots/nodes to pack delta records from.
        self._dirty_slots: Set[int] = set()
        self._dirty_nodes: Set[int] = set()
        self._cache: Optional[FlowProblem] = None
        self._cache_nodes_ok = False
        self._cache_arcs_ok = False

    # -- mutation bookkeeping ---------------------------------------------

    def _touch_slot(self, slot: int) -> None:
        self._dirty_slots.add(slot)
        self._cache_arcs_ok = False

    def _touch_node(self, node: int) -> None:
        self._dirty_nodes.add(node)
        self._cache_nodes_ok = False

    def _reset_tracking(self) -> None:
        """After a full (re)build every consumer must resync from the
        arrays wholesale; per-entry dirt from the build is noise."""
        self._dirty_slots.clear()
        self._dirty_nodes.clear()
        self._cache = None
        self._cache_nodes_ok = False
        self._cache_arcs_ok = False

    def drain_dirty(self) -> Tuple[np.ndarray, np.ndarray]:
        """The slots/nodes touched since the last drain, sorted (set
        order is not deterministic; packed records must be), and clear
        them. Consumed by DeviceResidentState.refresh()."""
        slots = np.sort(np.fromiter(self._dirty_slots, np.int32, len(self._dirty_slots)))
        nodes = np.sort(np.fromiter(self._dirty_nodes, np.int32, len(self._dirty_nodes)))
        self._dirty_slots.clear()
        self._dirty_nodes.clear()
        return slots, nodes

    # -- construction -----------------------------------------------------

    def _alloc(self, n: int, m: int) -> None:
        self.n_cap = max(next_pow2(n), 16)
        self.m_cap = max(next_pow2(m), 16)
        self.excess = np.zeros(self.n_cap, dtype=np.int64)  # kschedlint: host-only (host numpy)
        self.node_type = np.full(self.n_cap, -1, dtype=np.int8)
        self.src = np.zeros(self.m_cap, dtype=np.int32)
        self.dst = np.zeros(self.m_cap, dtype=np.int32)
        self.cap = np.zeros(self.m_cap, dtype=np.int32)
        self.low = np.zeros(self.m_cap, dtype=np.int32)
        self.cost = np.zeros(self.m_cap, dtype=np.int32)
        self.fold = np.zeros(self.n_cap, dtype=np.int64)  # kschedlint: host-only (host numpy)
        self.generation += 1
        self.plan.invalidate()

    def plan_key(self) -> Tuple:
        """Endpoint-structure generation key for this state's current
        arrays (see FlowProblem.plan_key)."""
        return (self._uid, self.rebuild_count, self.n_cap, self.m_cap, self.endpoint_gen)

    def full_build(self, graph: FlowGraph) -> None:
        n = graph.max_node_id
        m = graph.num_arcs
        self._alloc(n, m)
        self._arc_slot.clear()
        self._free_slots.clear()
        self._num_slots = 0
        self.num_nodes = n
        for node in graph.nodes():
            self.excess[node.id] = node.excess
            self.node_type[node.id] = int(node.type)
        for arc in graph.arcs():
            self._set_arc(arc.src, arc.dst, arc.cap_lower, arc.cap_upper, arc.cost)
        self.rebuild_count += 1  # slot table reassigned: device mirrors resync
        self._reset_tracking()

    # -- incremental updates ----------------------------------------------

    def _grow_nodes(self, need: int) -> None:
        new_cap = next_pow2(need)
        if new_cap <= self.n_cap:
            return
        self.excess = np.concatenate([self.excess, np.zeros(new_cap - self.n_cap, np.int64)])  # kschedlint: host-only (host numpy)
        self.node_type = np.concatenate(
            [self.node_type, np.full(new_cap - self.n_cap, -1, np.int8)]
        )
        self.fold = np.concatenate([self.fold, np.zeros(new_cap - self.n_cap, np.int64)])  # kschedlint: host-only (host numpy)
        self.n_cap = new_cap
        self.generation += 1
        self.plan.invalidate()  # regions must cover the new rows
        # shapes changed: every cached materialization is stale
        self._cache = None
        self._cache_nodes_ok = False
        self._cache_arcs_ok = False

    def _grow_arcs(self, need: int) -> None:
        new_cap = next_pow2(need)
        if new_cap <= self.m_cap:
            return
        pad = new_cap - self.m_cap
        for name in ("src", "dst", "cap", "low", "cost"):
            arr = getattr(self, name)
            setattr(self, name, np.concatenate([arr, np.zeros(pad, arr.dtype)]))
        self.m_cap = new_cap
        self.generation += 1
        self.plan.invalidate()  # entry budget + inv_order extent stale
        self._cache = None
        self._cache_nodes_ok = False
        self._cache_arcs_ok = False

    def _take_slot(self) -> int:
        if self._free_slots:
            return self._free_slots.pop()
        slot = self._num_slots
        self._grow_arcs(slot + 1)
        self._num_slots += 1
        return slot

    def _set_arc(self, src: int, dst: int, low: int, cap: int, cost: int) -> None:
        key = (src, dst)
        slot = self._arc_slot.get(key)
        low0 = int(self.low[slot]) if slot is not None else 0
        if cap == 0 and low == 0:
            if slot is not None:
                self.plan.slot_freed(slot, src, dst)
                self.endpoint_gen += 1
                self.cap[slot] = 0
                self.low[slot] = 0
                self.cost[slot] = 0
                self.src[slot] = 0
                self.dst[slot] = 0
                del self._arc_slot[key]
                self._free_slots.append(slot)
                self._touch_slot(slot)
                if low0:
                    self.fold[src] += low0
                    self.fold[dst] -= low0
                    self._touch_node(src)
                    self._touch_node(dst)
            return
        if slot is None:
            slot = self._take_slot()
            self._arc_slot[key] = slot
            self.plan.slot_assigned(slot, src, dst)
            self.endpoint_gen += 1
        if low != low0:
            # fold delta: an arc (src, dst) with lower bound L
            # contributes -L to src's folded excess and +L to dst's
            self.fold[src] += low0 - low
            self.fold[dst] += low - low0
            self._touch_node(src)
            self._touch_node(dst)
        self.src[slot] = src
        self.dst[slot] = dst
        self.cap[slot] = cap
        self.low[slot] = low
        self.cost[slot] = cost
        self._touch_slot(slot)

    def apply_changes(self, changes: List[Change]) -> None:
        for ch in changes:
            if isinstance(ch, AddNodeChange):
                self._grow_nodes(ch.node_id + 1)
                self.excess[ch.node_id] = ch.excess
                self.node_type[ch.node_id] = int(ch.node_type)
                self.num_nodes = max(self.num_nodes, ch.node_id + 1)
                self._touch_node(ch.node_id)
            elif isinstance(ch, RemoveNodeChange):
                self.excess[ch.node_id] = 0
                self.node_type[ch.node_id] = -1
                self._touch_node(ch.node_id)
            elif isinstance(ch, (NewArcChange, ChangeArcChange)):
                self._set_arc(ch.src, ch.dst, ch.cap_lower, ch.cap_upper, ch.cost)
            else:  # pragma: no cover
                raise TypeError(f"unknown change record: {ch!r}")

    def set_excess(self, node_id: int, excess: int) -> None:
        """Sink-excess bookkeeping happens outside the journal in the
        reference (graph_manager.go:636-640); mirror of that path. A
        no-op write stays invisible to the dirty tracking, so the
        every-round sink sync does not invalidate a clean cache."""
        if int(self.excess[node_id]) != excess:
            self.excess[node_id] = excess
            self._touch_node(node_id)

    # -- solver view ------------------------------------------------------

    def problem(self) -> FlowProblem:
        """Materialize the lower-bound-folded FlowProblem view.

        Copies the arrays (never aliases them) so a solver can keep its
        snapshot while further host mutations accumulate — but only the
        array GROUPS a journal entry touched since the last materialize
        are re-copied/refolded: the node side (excess, node_type) and
        the arc side (src/dst/cap/cost/flow_offset) invalidate
        independently, and a mutation-free round returns the cached
        FlowProblem outright. The lower-bound fold is the incrementally
        maintained ``fold`` array (one vector add), not a scatter pass.
        """
        cache = self._cache
        if cache is not None and self._cache_nodes_ok and self._cache_arcs_ok:
            return cache
        m = self.m_cap
        if cache is not None and self._cache_arcs_ok:
            src, dst, cap = cache.src, cache.dst, cache.cap
            cost, flow_offset = cache.cost, cache.flow_offset
        else:
            low = self.low[:m]
            src = self.src[:m].copy()
            dst = self.dst[:m].copy()
            cap = self.cap[:m] - low  # folded residual bound (new array)
            cost = self.cost[:m].copy()
            flow_offset = low.astype(np.int32)
        if cache is not None and self._cache_nodes_ok:
            excess, node_type = cache.excess, cache.node_type
        else:
            excess = self.excess + self.fold  # folded supply (new array)
            node_type = self.node_type.copy()
        self._cache = FlowProblem(
            num_nodes=self.n_cap,
            excess=excess,
            node_type=node_type,
            src=src,
            dst=dst,
            cap=cap,
            cost=cost,
            flow_offset=flow_offset,
            num_arcs=self._num_slots,
            plan=self.plan,
            plan_key=self.plan_key(),
        )
        self._cache_nodes_ok = True
        self._cache_arcs_ok = True
        return self._cache




# ---------------------------------------------------------------------------
# Device-resident mirror: persistent tensors + packed-record delta scatter
# ---------------------------------------------------------------------------

#: int32 columns of one packed arc delta record:
#: (slot, src, dst, folded cap, cost). flow_offset stays host-only: no
#: solver reads it on the device (decode adds it back on the host).
ARC_RECORD_COLS = 5
#: int32 columns of one packed node delta record: (node, folded excess)
NODE_RECORD_COLS = 2
#: smallest padded record count: tiny deltas share one bucket
MIN_RECORD_BUCKET = 8


def pad_record_count(k: int) -> int:
    """Pow2 bucket for a delta-record count (>= 1 so an empty delta
    still has a well-formed, idempotent record to ship)."""
    return max(next_pow2(max(k, 1)), MIN_RECORD_BUCKET)


def delta_apply(excess, src, dst, cap, cost, arc_rec, node_rec):  # kschedlint: program=delta_apply
    """Apply a round's packed delta records (int32 tensors on the
    mirror's device) to the persistent tensors; returns the new
    (excess, src, dst, cap, cost).

    excess, cap and cost are updated in place: the JAX package donates
    them to its delta program. src and dst are not donated there: the
    pre-delta endpoint tensors stay alive as the warm-flow masks
    (`device_warm_flow`) and as the solvers' last-solve endpoints, so
    here they get new tensors (clone, then scatter). Updating them in
    place would rewrite the tensors a solver compares against and pass
    every arc through its warm mask.

    Records are pow2-padded by repeating a real record (or, for an empty
    delta, re-writing slot/node 0 with its current values): duplicate
    indices carry equal values, so the scatter order cannot matter."""
    nid = node_rec[:, 0].long()  # kschedlint: index-only (index_copy_ positions)
    excess.index_copy_(0, nid, node_rec[:, 1].contiguous())
    slot = arc_rec[:, 0].long()  # kschedlint: index-only (index_copy_ positions)
    src = src.clone().index_copy_(0, slot, arc_rec[:, 1].contiguous())
    dst = dst.clone().index_copy_(0, slot, arc_rec[:, 2].contiguous())
    cap.index_copy_(0, slot, arc_rec[:, 3].contiguous())
    cost.index_copy_(0, slot, arc_rec[:, 4].contiguous())
    return excess, src, dst, cap, cost


def device_warm_flow(prev_flow, src_prev, dst_prev, src, dst, cap):  # kschedlint: program=warm_flow
    """The previous round's flow kept where the arc endpoints are
    unchanged (compared with the endpoint tensors the solver captured at
    its last successful solve) and clipped to the new capacities:
    the host path's ``np.where(same, minimum(prev, cap), 0)``."""
    same = (src_prev == src) & (dst_prev == dst)
    return torch.where(same, torch.minimum(prev_flow, cap), 0).to(torch.int32)


@dataclass
class DeviceResidentProblem(FlowProblem):
    """A FlowProblem whose folded arrays also live as persistent tensors
    on the card. The host arrays stay populated (decode and the
    objective read them); device-aware solvers read the ``d_*`` tensors
    instead of uploading."""

    d_excess: object = None  # int32[n_cap] folded supply
    d_src: object = None  # int32[m_cap]
    d_dst: object = None  # int32[m_cap]
    d_cap: object = None  # int32[m_cap] folded residual bound
    d_cost: object = None  # int32[m_cap] UNSCALED costs
    #: scatter-maintained slot-stable plan tensors in _solve_mcmf order
    #: (graph/slot_plan.py), or None while the plan is inactive or held
    #: sharded
    d_plan: object = None
    #: the same in sharded plan mode: this rank's [Es] blocks of the
    #: entry-shaped tensors and the replicated rest (a single-device
    #: solver given such a problem uploads the host plan instead)
    d_plan_shard: object = None
    resident: object = None  # owning DeviceResidentState
    version: int = 0

    def device_scaled_cost(self):
        """Costs pre-scaled by the node count (the general-graph
        solvers' exactness convention), computed on the card once per
        refresh and cached on the owning resident state."""
        return self.resident.scaled_cost(self)


def resident_solver_inputs(problem, prev_flow, prev_src, prev_dst, warm_start,
                           device):
    """The shared device-resident solve prologue of the general-graph
    backends (jax/ell/mega) on `device`: the solve's (cap, scaled cost,
    supply) read straight from the persistent tensors, and the warm flow
    derived on the card from the solver's previous flow, masked against
    the endpoint tensors it captured at its last successful solve.
    Returns ``(dev_args, flow0, warm)``; raises ValueError when the
    mirror lives on another device than the solver."""
    on = problem.d_cap.device
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"a device-resident problem on {problem.d_cap.device} "
                         f"handed to a solver on {device}")
    m = problem.d_cap.shape[0]
    dev_args = (problem.d_cap, problem.device_scaled_cost(), problem.d_excess)
    warm = (
        warm_start
        and prev_flow is not None
        and prev_flow.shape[0] == m
        and prev_src is not None
        and prev_src.shape[0] == m
    )
    if warm:
        flow0 = device_warm_flow(prev_flow, prev_src, prev_dst,
                                 problem.d_src, problem.d_dst, problem.d_cap)
    else:
        flow0 = torch.zeros(m, dtype=torch.int32, device=problem.d_cap.device)
    return dev_args, flow0, warm


#: the entry-shaped plan tensors, split by owner in sharded mode
_ENTRY_PLAN_NAMES = ("p_arc", "p_sign", "p_src", "p_dst", "seg_start", "is_start")


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """A tensor on `device` that owns its memory (never a view of the
    host array: the mirror is updated in place)."""
    return torch.tensor(x, device=device)  # kschedlint: disable=implicit-dtype -- keeps the host array's dtype (int32 or bool)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceResidentState:
    """Persistent mirror, on `device`, of a DeviceGraphState's folded
    problem arrays.

    ``refresh()`` (once per round, after the journal is applied on the
    host) packs the touched slots/nodes into flat int32 records, ships
    only those bytes and scatters them into the tensors. The mirror is
    rebuilt wholesale only when ``full_build`` reassigned the slot table,
    the arc pow2 bucket grew (m_cap), or the node bucket grew (n_cap;
    node side only). ``last_upload_bytes`` / ``last_upload_kind`` give
    the exact bytes that crossed to the card this refresh, plan records
    included; the device profiler's h2d byte counter reads them
    (solver/placement.py). Entry points default to the card and raise
    without one.
    """

    def __init__(self, state: DeviceGraphState, device="cuda") -> None:
        from ..utils.device import resolve_device

        self.state = state
        self.device = resolve_device(device)
        self.d_excess = None
        self.d_src = None
        self.d_dst = None
        self.d_cap = None
        self.d_cost = None
        self._rebuild_count = -1
        self._n_cap = -1
        self._m_cap = -1
        self.version = 0
        self.last_upload_bytes = 0
        self.last_upload_kind = "full_build"
        self.last_arc_records = 0
        self.last_node_records = 0
        self._scaled = None  # (version, scaled-cost tensor)
        # ---- slot-stable plan mirror (graph/slot_plan.py) ------------
        self.d_p_arc = None
        self.d_p_sign = None
        self.d_p_src = None
        self.d_p_dst = None
        self.d_inv = None
        #: boundary statics: mirror-owned copies (updated in place when a
        #: relocation rewires them, so never the plan's upload cache)
        self.d_seg = None
        self.d_isstart = None
        self.d_first = None
        self.d_last = None
        self.d_nonempty = None
        self._plan_gen = -1  # layout_gen mirrored
        self._plan_ver = -1  # value_version mirrored
        self.last_plan_kind = "none"  # none | rebuild | delta | clean
        #: plan bytes of the last sync: the global count (every shard's
        #: records, the JAX package's [D, K, cols] total) and what this
        #: rank itself uploaded (equal when the mirror is not sharded)
        self.last_plan_bytes = 0
        self.last_plan_rank_bytes = 0
        self.last_plan_records = 0
        #: sharded plan mirror mode (enable_sharded_plan): the mesh whose
        #: rank this process is, or None for the single-device mirror
        self._shard = None

    # -- packing -----------------------------------------------------------

    def _pack_arcs(self, slots: np.ndarray) -> np.ndarray:
        st = self.state
        ka = len(slots)
        rec = np.zeros((pad_record_count(ka), ARC_RECORD_COLS), np.int32)
        if ka:
            low = st.low[slots]
            rec[:ka, 0] = slots
            rec[:ka, 1] = st.src[slots]
            rec[:ka, 2] = st.dst[slots]
            rec[:ka, 3] = st.cap[slots] - low
            rec[:ka, 4] = st.cost[slots]
            rec[ka:] = rec[0]  # idempotent pad: repeat a real record
        else:
            rec[:, 1] = st.src[0]
            rec[:, 2] = st.dst[0]
            rec[:, 3] = st.cap[0] - st.low[0]
            rec[:, 4] = st.cost[0]
        return rec

    def _pack_nodes(self, nodes: np.ndarray) -> np.ndarray:
        st = self.state
        kn = len(nodes)
        rec = np.zeros((pad_record_count(kn), NODE_RECORD_COLS), np.int32)
        if kn:
            rec[:kn, 0] = nodes
            rec[:kn, 1] = (st.excess[nodes] + st.fold[nodes]).astype(np.int32)
            rec[kn:] = rec[0]
        else:
            rec[:, 1] = np.int32(int(st.excess[0]) + int(st.fold[0]))
        return rec

    # -- refresh -----------------------------------------------------------

    def _full_upload(self, problem: FlowProblem, arcs_too: bool) -> int:
        dev = self.device
        self.d_excess = _upload(problem.excess.astype(np.int32), dev)
        nbytes = _nbytes(self.d_excess)
        if arcs_too:
            self.d_src = _upload(problem.src, dev)
            self.d_dst = _upload(problem.dst, dev)
            self.d_cap = _upload(problem.cap, dev)
            self.d_cost = _upload(problem.cost.astype(np.int32), dev)
            nbytes += sum(_nbytes(t) for t in
                          (self.d_src, self.d_dst, self.d_cap, self.d_cost))
        return nbytes

    def _apply(self, arc_rec: np.ndarray, node_rec: np.ndarray) -> None:
        dev = self.device
        (self.d_excess, self.d_src, self.d_dst, self.d_cap, self.d_cost) = (
            delta_apply(self.d_excess, self.d_src, self.d_dst, self.d_cap,
                        self.d_cost, _upload(arc_rec, dev), _upload(node_rec, dev)))

    def refresh(self) -> DeviceResidentProblem:
        """Sync the mirror with the host state and return the
        device-resident problem handle for this round's solve."""
        from ..obs.spans import span

        st = self.state
        problem = st.problem()
        slots, nodes = st.drain_dirty()
        rebuilt = self._rebuild_count != st.rebuild_count
        arcs_stale = rebuilt or self._m_cap != st.m_cap or self.d_src is None
        nodes_stale = rebuilt or self._n_cap != st.n_cap or self.d_excess is None
        if arcs_stale or nodes_stale:
            with span("delta_upload",
                      kind="full_build" if arcs_stale else "node_rebuild"):
                nbytes = self._full_upload(problem, arcs_too=arcs_stale)
                if not arcs_stale:
                    # node bucket grew, arc side still delta-sized: the
                    # endpoint geometry survives, so warm flow does too
                    arc_rec = self._pack_arcs(slots)
                    self._apply(arc_rec, self._pack_nodes(np.zeros(0, np.int32)))
                    nbytes += arc_rec.nbytes
            self.last_upload_kind = "full_build"
            self.last_upload_bytes = nbytes
        else:
            with span("delta_pack", arcs=len(slots), nodes=len(nodes)):
                arc_rec = self._pack_arcs(slots)
                node_rec = self._pack_nodes(nodes)
            with span("delta_upload", bytes=arc_rec.nbytes + node_rec.nbytes):
                self._apply(arc_rec, node_rec)
            self.last_upload_kind = "delta"
            self.last_upload_bytes = arc_rec.nbytes + node_rec.nbytes
        self.last_arc_records = len(slots)
        self.last_node_records = len(nodes)
        self._rebuild_count = st.rebuild_count
        self._n_cap = st.n_cap
        self._m_cap = st.m_cap
        self.version += 1
        d_plan = self._sync_plan()
        sharded = self._shard is not None
        return DeviceResidentProblem(
            num_nodes=problem.num_nodes,
            excess=problem.excess,
            node_type=problem.node_type,
            src=problem.src,
            dst=problem.dst,
            cap=problem.cap,
            cost=problem.cost,
            flow_offset=problem.flow_offset,
            num_arcs=problem.num_arcs,
            d_excess=self.d_excess,
            d_src=self.d_src,
            d_dst=self.d_dst,
            d_cap=self.d_cap,
            d_cost=self.d_cost,
            d_plan=None if sharded else d_plan,
            d_plan_shard=d_plan if sharded else None,
            resident=self,
            version=self.version,
            plan=st.plan,
            plan_key=st.plan_key(),
        )

    def enable_sharded_plan(self, mesh) -> None:
        """Maintain the slot-plan mirror in SHARDED form for the
        multi-device rung (parallel/sharded_solver.py): the owning
        SlotPlanState switches to the per-shard block layout, this rank
        holds its [Es] block of the entry-shaped tensors (the partition
        rules) and the rest whole, and each round's dirty rows and
        segment statics are routed to their owner ranks. `mesh` is a
        parallel.mesh.ShardMesh on this mirror's device. Idempotent per
        mesh."""
        if self._shard is mesh:
            return
        if mesh.device != self.device:
            raise TypeError(f"a mesh on {mesh.device} for a mirror on {self.device}")
        self._shard = mesh
        self.state.plan.enable_sharding(mesh.size)
        self._plan_gen = -1  # mode flip: the next sync re-uploads wholesale

    def _plan_tensors(self) -> Tuple:
        """The mirrored plan tensors in `_solve_mcmf` order."""
        return (
            self.d_p_arc, self.d_p_sign, self.d_p_src, self.d_p_dst,
            self.d_seg, self.d_isstart, self.d_inv,
            self.d_first, self.d_last, self.d_nonempty,
        )

    def _upload_plan_full(self, plan) -> int:
        """Fresh plan tensors from the host truth (the rebuild path and
        the integrity ladder's reupload rung); in sharded mode this
        rank's blocks of the entry tensors and the rest whole. Returns
        the bytes this rank uploaded."""
        if self._shard is None:
            tensors = tuple(_upload(x, self.device) for x in plan.host_args())
        else:
            from ..parallel.sharded_solver import place_sharded_plan

            mesh = self._shard
            tensors = place_sharded_plan(mesh, plan.host_args(), mesh.size,
                                         plan.block_extent)
        (
            self.d_p_arc, self.d_p_sign, self.d_p_src, self.d_p_dst,
            self.d_seg, self.d_isstart, self.d_inv,
            self.d_first, self.d_last, self.d_nonempty,
        ) = tensors
        return sum(_nbytes(t) for t in tensors)

    def _scatter_plan_delta(self, plan) -> Tuple[int, int]:
        """Apply a round's dirty plan records; (bytes, records), the
        global counts. In sharded mode the `plan_upload` span carries
        both the global bytes and this rank's (`rank_bytes`)."""
        from ..obs.spans import span

        if self._shard is None:
            from .slot_plan import plan_apply

            recs = plan.drain_records()
            rec_bytes = sum(r.nbytes for r in recs)
            with span("plan_upload", kind="delta", bytes=rec_bytes):
                plan_apply(self._plan_tensors(),
                           *(_upload(r, self.device) for r in recs))
            self.last_plan_rank_bytes = rec_bytes
            return rec_bytes, sum(len(r) for r in recs)
        from ..parallel.sharded_solver import (
            replicated_plan_apply_fn,
            sharded_plan_apply_fn,
        )

        mesh = self._shard
        row_rec, seg_rec, inv_rec, node_rec = plan.drain_records_sharded()
        rec_bytes = row_rec.nbytes + seg_rec.nbytes + inv_rec.nbytes + node_rec.nbytes
        # this rank ships its own [K, cols] slices and the replicated
        # streams whole
        rank_bytes = (row_rec[mesh.rank].nbytes + seg_rec[mesh.rank].nbytes
                      + inv_rec.nbytes + node_rec.nbytes)
        with span("plan_upload", kind="sharded_delta", bytes=rec_bytes,
                  rank_bytes=rank_bytes, shards=mesh.size):
            sharded_plan_apply_fn(mesh)(
                self.d_p_arc, self.d_p_sign, self.d_p_src, self.d_p_dst,
                self.d_seg, self.d_isstart, row_rec, seg_rec)
            replicated_plan_apply_fn()(
                self.d_inv, self.d_first, self.d_last, self.d_nonempty,
                inv_rec, node_rec)
        self.last_plan_rank_bytes = rank_bytes
        records = (int(np.prod(row_rec.shape[:2])) + int(np.prod(seg_rec.shape[:2]))
                   + len(inv_rec) + len(node_rec))
        return rec_bytes, records

    def _sync_plan(self):
        """Mirror the slot-stable plan as persistent tensors. Inactive
        until a slot-stable consumer enables the plan (so other backends
        pay nothing); afterwards each round ships only the dirty plan
        rows / inv entries through `plan_apply`, and the full re-upload
        survives only on layout rebuilds. Returns the plan tensors in
        `_solve_mcmf` order, or None while inactive."""
        from ..obs.spans import span

        plan = self.state.plan
        self.last_plan_kind = "none"
        self.last_plan_bytes = 0
        self.last_plan_rank_bytes = 0
        self.last_plan_records = 0
        if plan is None or not plan.enabled:
            return None
        plan.ensure_built()
        if self._plan_gen != plan.layout_gen:
            with span("plan_upload", kind="rebuild") as sp:
                self.last_plan_rank_bytes = self._upload_plan_full(plan)
                if self._shard is not None:
                    sp.set("rank_bytes", self.last_plan_rank_bytes)
            plan.clear_pending()
            self._plan_gen = plan.layout_gen
            self._plan_ver = plan.value_version
            self.last_plan_kind = "rebuild"
            self.last_plan_bytes = plan.values_nbytes() + plan.static_nbytes()
            self.last_upload_bytes += self.last_plan_bytes
        elif plan.value_version != self._plan_ver or plan.has_pending:
            rec_bytes, records = self._scatter_plan_delta(plan)
            self._plan_ver = plan.value_version
            self.last_plan_kind = "delta"
            self.last_plan_bytes = rec_bytes
            self.last_plan_records = records
            self.last_upload_bytes += self.last_plan_bytes
        else:
            self.last_plan_kind = "clean"
        return self._plan_tensors()

    def scaled_cost(self, problem: DeviceResidentProblem):  # kschedlint: program=scale_cost
        """d_cost * num_nodes (int32), computed on the card, cached per
        refresh."""
        if self._scaled is None or self._scaled[0] != problem.version:
            self._scaled = (problem.version,
                            problem.d_cost * int(problem.num_nodes))
        return self._scaled[1]

    def plan_fingerprints(self) -> np.ndarray:  # kschedlint: program=plan_fingerprint
        """uint32 checksum per mirrored plan tensor, in FP_PLAN_ARRAYS
        order (runtime/integrity.StateAuditor). The sharded mirror
        psums per-shard partials with global-index weights, so both
        modes compare against the same host twins."""
        bufs = (
            self.d_p_arc, self.d_p_sign, self.d_p_src, self.d_p_dst,
            self.d_inv, self.d_seg, self.d_isstart,
            self.d_first, self.d_last, self.d_nonempty,
        )
        if self._shard is None:
            from ..runtime.integrity import device_fingerprints

            return device_fingerprints(bufs)
        from ..parallel.sharded_solver import sharded_plan_fingerprint_fn

        return sharded_plan_fingerprint_fn(self._shard)(*bufs)

    def plan_host_view(self, name: str, tensor) -> np.ndarray:
        """A mirrored plan tensor as the host holds it: in sharded mode
        an entry-shaped block is gathered from every rank (a collective:
        every rank calls this for the same tensors in the same order)."""
        if self._shard is not None and name in _ENTRY_PLAN_NAMES:
            from ..parallel.sharded_solver import gather_block

            return gather_block(self._shard, tensor)
        return tensor.cpu().numpy()

    def rebind(self, problem: DeviceResidentProblem) -> None:
        """Re-point a problem handle at the mirror's CURRENT tensors.
        Required after any out-of-band tensor replacement (divergence
        repair, injected corruption): a handle built at refresh time
        would read the replaced tensors."""
        problem.d_excess = self.d_excess
        problem.d_src = self.d_src
        problem.d_dst = self.d_dst
        problem.d_cap = self.d_cap
        problem.d_cost = self.d_cost
        if self._plan_gen >= 0:
            if problem.d_plan is not None:
                problem.d_plan = self._plan_tensors()
            if problem.d_plan_shard is not None:
                problem.d_plan_shard = self._plan_tensors()
        self._scaled = None

    def parity_check(self) -> None:
        """Verify the mirror equals the host folded view bit for bit
        (fetches the tensors; audit/debug — the cheap per-round path is
        the fingerprint audit in runtime/integrity.py). Raises a
        structured IntegrityError carrying a bounded diff."""
        from ..runtime.integrity import bounded_diff

        problem = self.state.problem()
        pairs = (
            ("excess", self.d_excess, problem.excess.astype(np.int32)),
            ("src", self.d_src, problem.src),
            ("dst", self.d_dst, problem.dst),
            ("cap", self.d_cap, problem.cap),
            ("cost", self.d_cost, problem.cost.astype(np.int32)),
        )
        for name, dev, host in pairs:
            got = dev.cpu().numpy()
            if got.dtype != host.dtype or not np.array_equal(got, host):
                raise bounded_diff(f"device mirror {name}", got, host)

    def plan_parity_check(self) -> None:
        """Verify the scatter-maintained plan tensors equal the host plan
        arrays bit for bit (test/debug); raises IntegrityError."""
        from ..runtime.integrity import bounded_diff

        plan = self.state.plan
        if plan is None or not plan.enabled or self._plan_gen < 0:
            return
        if plan.needs_rebuild or self._plan_gen != plan.layout_gen or (
            self._plan_ver != plan.value_version
        ):
            return  # mirror legitimately behind (mutations since refresh)
        names = ("p_arc", "p_sign", "p_src", "p_dst", "seg_start", "is_start",
                 "inv_order", "node_first", "node_last", "node_nonempty")
        for name, dev, host in zip(names, self._plan_tensors(), plan.host_args()):
            got = self.plan_host_view(name, dev)
            if got.dtype != host.dtype or not np.array_equal(got, host):
                raise bounded_diff(f"device plan mirror {name}", got, host)


from ..analysis.program_registry import declare_programs as _declare_programs  # noqa: E402

_declare_programs(
    __name__,
    "delta_apply",
    "warm_flow",
    "scale_cost",
    "plan_fingerprint",
)
