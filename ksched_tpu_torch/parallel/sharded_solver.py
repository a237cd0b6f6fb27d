"""Multi-device MCMF: the scan-CSR push-relabel solve sharded over a
ShardMesh.

Port of ksched_tpu/parallel/sharded_solver.py. Residual entries are
partitioned by the OWNER of their source node (so every node's outgoing
entries, the unit of push and relabel work, live on exactly one shard),
while flow and potentials are replicated and combined over the mesh
each superstep:

- per-shard segment reductions reuse the single-device solve's
  machinery (solver/csr_solver.py: cumsum and boundary gathers, and its
  segmented min/max in place of `lax.associative_scan`); cross-shard
  combination is a psum of owner-masked dense vectors (each node and arc
  has exactly one contributing shard, so the psum selects the owner's
  value);
- pushes and relabels of a node are computed entirely on its owner from
  replicated state, so the single-device eps-optimality argument
  carries over unchanged, and so does every bit of the result;
- price tightening distributes the same way: the per-node min over
  outgoing entries is owner-local, then pmin-combined.

Each superstep issues three psums: the [N] excess of the loop's test
(call site "loop"), the [M] arc deltas and the [N] potentials
("superstep"), the JAX program's budget of 3 psums. A phase change
adds the loop's excess psum and the saturate's two pmax ("phase"), a
tightening sweep one pmin ("sweep"). The telemetry ring, when on, adds
four scalar psums per superstep ("telemetry"), so its rows are global.

The JAX package runs these as XLA programs under shard_map. Here they
are plain PyTorch on each rank's device, SPMD over torch.distributed:
every rank runs the same host program on the same replicated problem,
holds only its own `[Es]` block of the entry tables, and every loop
condition is computed from all-reduced values, so the ranks leave every
loop together.

Two solve paths, as in the JAX package: the legacy `build_sharded_plan`
argsort plan for plain array problems, and the slot-stable path that
consumes the maintained plan of graph/slot_plan.py in sharded layout
mode (each rank's block of the ten plan tensors, from the sharded
device-resident mirror or from the plan's host arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..analysis.marks import loop_mark
from ..graph.device_export import FlowProblem
from ..solver.base import FlowResult, FlowSolver
from ..solver.csr_solver import _seg_max, _seg_min, _seg_sum
from ..solver.layered import validate_alpha
from .mesh import ShardMesh

_I32 = torch.int32
_BIG = 1 << 30
_BIG_D = 1 << 28
_MASK32 = 0xFFFFFFFF


@dataclass
class ShardedPlan:
    """Host-prebuilt per-shard CSR data, stacked on a leading shard axis
    (every rank builds all of it; each takes its own row)."""

    # [D, E] per-shard sorted entries (E = padded per-shard entry count)
    s_arc: np.ndarray
    s_sign: np.ndarray
    s_src: np.ndarray
    s_dst: np.ndarray
    s_segstart: np.ndarray  # local sorted index of entry's segment start
    s_isstart: np.ndarray
    s_valid: np.ndarray  # bool, padding mask
    # [D, N] per-node segment boundaries within the shard's local entries
    node_first: np.ndarray
    node_last: np.ndarray
    node_nonempty: np.ndarray
    owned: np.ndarray  # bool [D, N]: shard owns this node
    # [D, M] position of arc j's fwd/bwd entry in this shard (E = zero pad)
    pos_fwd: np.ndarray
    pos_bwd: np.ndarray
    src: np.ndarray  # [M] the endpoints this plan was built for
    dst: np.ndarray

    def shard_tensors(self, rank: int, device) -> Tuple:
        """Rank `rank`'s row of the thirteen per-shard tables, in the
        order `make_sharded_solver`'s function takes them."""
        return tuple(
            torch.as_tensor(np.ascontiguousarray(x[rank]), device=device)
            for x in (
                self.s_arc, self.s_sign, self.s_src, self.s_dst,
                self.s_segstart, self.s_isstart, self.s_valid,
                self.node_first, self.node_last, self.node_nonempty,
                self.owned, self.pos_fwd, self.pos_bwd,
            )
        )


def node_owner(node_ids: np.ndarray, num_nodes: int, num_shards: int) -> np.ndarray:
    """Owner shard per node: a contiguous range partition. It is
    graph/slot_plan.shard_owner, so the slot-stable sharded layout and
    `build_sharded_plan` agree on ownership."""
    from ..graph.slot_plan import shard_owner

    return shard_owner(node_ids, num_nodes, num_shards)


def build_sharded_plan(src: np.ndarray, dst: np.ndarray, num_nodes: int, num_shards: int) -> ShardedPlan:
    m = len(src)
    esrc = np.concatenate([src, dst])
    edst = np.concatenate([dst, src])
    earc = np.concatenate([np.arange(m), np.arange(m)]).astype(np.int32)
    esign = np.concatenate([np.ones(m), -np.ones(m)]).astype(np.int32)
    owner = node_owner(esrc, num_nodes, num_shards)

    per_shard = [np.nonzero(owner == d)[0] for d in range(num_shards)]
    e_max = max((len(ix) for ix in per_shard), default=1)
    # one spare slot past the densest shard: pos_fwd/pos_bwd default
    # there, and it is invalid on every shard, so padded gathers read 0
    e_pad = e_max + 1

    def stack(fill, dtype):
        return np.full((num_shards, e_pad), fill, dtype=dtype)

    s_arc = stack(0, np.int32)
    s_sign = stack(1, np.int32)
    s_src = stack(0, np.int32)
    s_dst = stack(0, np.int32)
    s_segstart = stack(0, np.int32)
    s_isstart = np.zeros((num_shards, e_pad), bool)
    s_valid = np.zeros((num_shards, e_pad), bool)
    node_first = np.zeros((num_shards, num_nodes), np.int32)
    node_last = np.zeros((num_shards, num_nodes), np.int32)
    node_nonempty = np.zeros((num_shards, num_nodes), bool)
    owned = np.zeros((num_shards, num_nodes), bool)
    pos_fwd = np.full((num_shards, m), e_pad - 1, np.int32)
    pos_bwd = np.full((num_shards, m), e_pad - 1, np.int32)

    node_ids = np.arange(num_nodes)
    node_owner_arr = node_owner(node_ids, num_nodes, num_shards)
    for d in range(num_shards):
        ix = per_shard[d]
        k = len(ix)
        order = np.argsort(esrc[ix], kind="stable")
        lsrc = esrc[ix][order]
        s_src[d, :k] = lsrc
        s_dst[d, :k] = edst[ix][order]
        s_arc[d, :k] = earc[ix][order]
        s_sign[d, :k] = esign[ix][order]
        s_valid[d, :k] = True
        counts = np.bincount(lsrc, minlength=num_nodes)
        row_ptr = np.zeros(num_nodes + 1, np.int64)  # kschedlint: host-only (host numpy)
        row_ptr[1:] = np.cumsum(counts)
        s_segstart[d, :k] = row_ptr[lsrc]
        starts = np.unique(row_ptr[lsrc]).astype(np.int64)  # kschedlint: host-only (host numpy)
        s_isstart[d, starts] = True
        node_first[d] = np.minimum(row_ptr[:-1], max(e_pad - 1, 0))
        node_last[d] = np.maximum(row_ptr[1:] - 1, 0)
        node_nonempty[d] = row_ptr[1:] > row_ptr[:-1]
        owned[d] = node_owner_arr == d
        # arc -> local entry position (the padding position reads delta
        # 0 because padded entries are never admissible)
        local_pos = np.arange(k, dtype=np.int64)  # kschedlint: host-only (host numpy)
        glob = ix[order]
        is_fwd = glob < m
        pos_fwd[d, earc[ix][order][is_fwd]] = local_pos[is_fwd]
        pos_bwd[d, earc[ix][order][~is_fwd]] = local_pos[~is_fwd]
    return ShardedPlan(
        s_arc=s_arc, s_sign=s_sign, s_src=s_src, s_dst=s_dst,
        s_segstart=s_segstart, s_isstart=s_isstart, s_valid=s_valid,
        node_first=node_first, node_last=node_last,
        node_nonempty=node_nonempty, owned=owned,
        pos_fwd=pos_fwd, pos_bwd=pos_bwd,
        src=src.copy(), dst=dst.copy(),
    )


def _sharded_mcmf(mesh: ShardMesh, cap, cost, supply, flow0, eps_init,
                  step_cap: int, s_arc, s_sign, s_src, s_dst, seg_local,
                  isstart, valid, node_first, node_last, nonempty, owned,
                  pf, pb, alpha: int, tighten_sweeps: int,
                  telemetry_cap: int, warm_p=None):
    """The shard body both paths share: this rank's entry block
    (`valid` None when dead rows are marked by sign 0), its local
    segment boundaries (`nonempty` already masked to owned nodes),
    per-arc local entry positions `pf`/`pb` (pointing at a dead or
    padded row where the entry lives on another shard), and the
    replicated problem. Returns (flow, p, steps, converged, p_overflow,
    ring or None); flow and p are replicated."""
    from ..obs import soltel

    dev = cap.device
    s_arc, s_src, s_dst, seg_local, node_first, node_last, pf, pb = (
        t.long() for t in (s_arc, s_src, s_dst, seg_local, node_first,  # kschedlint: index-only (gather index)
                           node_last, pf, pb))
    s_sign = s_sign.to(_I32)
    isstart = isstart.to(torch.bool)
    nonempty = nonempty.to(torch.bool)
    s_cost = s_sign * cost[s_arc]

    def mask(x, fill=0):
        return x if valid is None else torch.where(valid, x, fill)

    def residual(flow):
        a_flow = flow[s_arc]
        r = torch.where(s_sign > 0, cap[s_arc] - a_flow,
                        torch.where(s_sign < 0, a_flow, 0))
        return mask(r)

    def excess_of(flow, site):
        contrib = _seg_sum(mask(s_sign * flow[s_arc]), node_first, node_last,
                           nonempty)
        contrib = torch.where(owned, contrib, 0)
        return supply - mesh.psum(contrib, site)

    def tighten(flow, d0=None):
        r = residual(flow)
        if d0 is None:
            exc0 = excess_of(flow, "tighten")
            d0 = torch.full_like(exc0, _BIG_D).masked_fill_(exc0 < 0, 0)
        d, changed, it = d0, True, 0
        while changed and it < tighten_sweeps:
            loop_mark("sweep")
            cand = torch.where(r > 0, s_cost + d[s_dst], _BIG_D)
            best = _seg_min(cand, isstart, node_last, nonempty, _BIG_D)
            best = mesh.pmin(torch.where(owned, best, _BIG_D), "sweep")
            d2 = torch.clamp(torch.minimum(d, best), min=-_BIG_D)
            changed = bool((d2 != d).any())  # d is replicated: every rank agrees
            d, it = d2, it + 1
        loop_mark()
        return -torch.clamp(d, max=_BIG_D)

    def arc_delta(delta):
        dz = mask(delta)
        return mesh.psum(dz[pf] - dz[pb], "superstep")

    def superstep(flow, p, eps, excess):
        r = residual(flow)
        rc = s_cost + p[s_src] - p[s_dst]
        e_at = excess[s_src]
        admissible = (r > 0) & (rc < 0) & (e_at > 0)
        r_adm = torch.where(admissible, r, 0)
        excl = torch.cumsum(r_adm, 0, dtype=_I32) - r_adm
        prefix_before = excl - excl[seg_local]
        delta = torch.minimum(torch.clamp(e_at - prefix_before, min=0), r_adm)
        new_flow = flow + arc_delta(delta)
        pushed = _seg_sum(delta, node_first, node_last, nonempty)
        sum_r = _seg_sum(r, node_first, node_last, nonempty)
        cand = torch.where(r > 0, p[s_dst] - s_cost, -_BIG)
        best = _seg_max(cand, isstart, node_last, nonempty, -_BIG)
        relabel = (excess > 0) & (pushed == 0) & (sum_r > 0) & owned
        p_local = torch.where(relabel, best - eps, torch.where(owned, p, 0))
        new_p = mesh.psum(torch.where(owned, p_local, 0), "superstep")
        if not telemetry_cap:
            return new_flow, new_p, ()
        # soltel cols 3..6: per-shard contributions psum'd to global
        # counts (each entry and owned node contributes on one shard)
        aux = (
            mesh.psum(torch.sum(pushed, dtype=_I32), "telemetry"),
            mesh.psum(torch.sum(relabel, dtype=_I32), "telemetry"),
            mesh.psum(torch.sum(mask((s_sign > 0) & (r == 0), False),
                                dtype=_I32), "telemetry"),
            mesh.psum(torch.sum(r_adm > 0, dtype=_I32), "telemetry"),
        )
        return new_flow, new_p, aux

    def sat_full(flow, p):
        rc = s_cost + p[s_src] - p[s_dst]
        want = torch.where((rc < 0) & (s_sign > 0), cap[s_arc], -1)
        want = torch.where((rc < 0) & (s_sign < 0), 0, want)
        want = mask(want, -1)
        tgt = torch.maximum(mesh.pmax(want[pf], "phase"),
                            mesh.pmax(want[pb], "phase"))
        return torch.where(tgt >= 0, tgt, flow)

    tel = soltel.device_ring(telemetry_cap, dev) if telemetry_cap else None
    if warm_p is not None:
        # dirty-frontier refit: the sweeps seeded from the carried prices
        p = tighten(flow0, d0=torch.clamp(-warm_p, -_BIG_D, _BIG_D))
    else:
        p = tighten(flow0)
    flow = sat_full(flow0, p)
    eps, steps, done = int(eps_init), 0, False
    while not done and steps < step_cap:
        loop_mark("superstep")
        excess = excess_of(flow, "loop")
        if bool((excess > 0).any()):  # replicated: every rank agrees
            flow, p, aux = superstep(flow, p, eps, excess)
            if telemetry_cap:
                soltel.device_ring_write(tel, steps, soltel.device_row(
                    eps, torch.sum(excess > 0, dtype=_I32),
                    torch.sum(excess.clamp(min=0), dtype=_I32), *aux,
                    device=dev))
            steps += 1
        elif eps <= 1:
            done = True
        else:
            flow = sat_full(flow, p)
            eps = max(1, eps // alpha)
    loop_mark()
    converged = done and int(excess_of(flow, "final").abs().max()) == 0
    p_overflow = int(p.abs().max()) >= (1 << 30)
    return flow, p, steps, converged, p_overflow, tel


def make_sharded_solver(mesh: ShardMesh, alpha: int, tighten_sweeps: int = 32,  # kschedlint: program=sharded_solve
                        telemetry_cap: int = 0):
    """The legacy sharded solve over `mesh`: a function of (cap, cost,
    supply, flow0, eps_init, step_cap) replicated and this rank's row of
    the thirteen ShardedPlan tables (`ShardedPlan.shard_tensors`).
    Returns (flow, steps, converged, p_overflow[, ring]); with
    telemetry_cap > 0 the soltel ring's rows are global (psum'd)."""
    def fn(cap, cost, supply, flow0, eps_init, step_cap,
           s_arc, s_sign, s_src, s_dst, s_segstart, s_isstart, s_valid,
           node_first, node_last, node_nonempty, owned, pos_fwd, pos_bwd):
        owned = owned.to(torch.bool)
        valid = s_valid.to(torch.bool)
        flow, _p, steps, conv, p_over, tel = _sharded_mcmf(
            mesh, cap, cost, supply, flow0, eps_init, int(step_cap),
            s_arc, s_sign, s_src, s_dst, s_segstart, s_isstart, valid,
            node_first, node_last, node_nonempty.to(torch.bool), owned,
            pos_fwd, pos_bwd, alpha, tighten_sweeps, telemetry_cap)
        base = (flow, steps, conv, p_over)
        return base + (tel,) if telemetry_cap else base

    return fn


# ---------------------------------------------------------------------------
# Slot-stable sharded solve: the maintained-layout multi-device rung
# ---------------------------------------------------------------------------


def sharded_entry_extent(m_pad: int, num_shards: int) -> int:
    """Per-shard entry-block extent of the slot-stable sharded layout in
    the common case: the (2*m_cap)/D floor slot_plan's sharded sizing
    applies, a function of the pow2 arc bucket and the shard count."""
    return max((2 * m_pad) // num_shards, 16)


#: the partition rules of the slot-stable sharded solve: the six
#: entry-shaped tensors are split by source-node OWNER, each rank taking
#: its own [Es] block; every node- and arc-space vector (problem arrays,
#: warm state, positions, boundary statics) is replicated and combined
#: over the mesh each superstep
SHARDED_PARTITION_RULES = (
    (r"^(p_arc|p_sign|p_src|p_dst|seg_start|is_start)$", "sharded"),
    (r"^(cap|cost|supply|flow0|eps|steps|warm_p)$", "replicated"),
    (r"^(inv_order|node_first|node_last|node_nonempty)$", "replicated"),
)


def match_partition_rules(names):
    """"sharded" or "replicated" per named tensor from
    SHARDED_PARTITION_RULES: the first matching rule wins, and an
    unknown name is an error (a new tensor is placed deliberately)."""
    import re

    kinds = []
    for name in names:
        for rule, kind in SHARDED_PARTITION_RULES:
            if re.search(rule, name):
                kinds.append(kind)
                break
        else:
            raise ValueError(f"no partition rule for tensor {name!r}")
    return tuple(kinds)


#: the plan tensors in SlotPlanState.host_args order
_PLAN_NAMES = ("p_arc", "p_sign", "p_src", "p_dst", "seg_start", "is_start",
               "inv_order", "node_first", "node_last", "node_nonempty")


def place_sharded_plan(mesh: ShardMesh, host_tensors,
                       num_shards: int, block_extent: int) -> Tuple:
    """The ten maintained plan tensors (SlotPlanState.host_args order)
    on this rank per SHARDED_PARTITION_RULES: each entry-shaped tensor
    as this rank's [Es] block, the rest whole. The one placement: the
    sharded solver's full-upload cache and the resident mirror's
    rebuild both call it."""
    if num_shards != mesh.size:
        raise ValueError(f"a {num_shards}-shard layout on a {mesh.size}-rank mesh")
    lo = mesh.rank * block_extent
    out = []
    for name, kind, x in zip(_PLAN_NAMES, match_partition_rules(_PLAN_NAMES),
                             host_tensors):
        if kind == "sharded":
            x = x[lo:lo + block_extent]
        out.append(torch.tensor(np.ascontiguousarray(x), device=mesh.device))  # kschedlint: disable=implicit-dtype -- keeps the host plan array's dtype (int32 or bool)
    return tuple(out)


#: argument names of the slot-stable sharded solve, in positional order
#: (warm_p appended by the use_warm_p variant)
_SLOT_SOLVE_ARGS = (
    "cap", "cost", "supply", "flow0", "eps", "steps",
    "p_arc", "p_sign", "p_src", "p_dst", "seg_start", "is_start",
    "inv_order", "node_first", "node_last", "node_nonempty",
)


def make_sharded_slot_solver(  # kschedlint: program=sharded_slot_solve
    mesh: ShardMesh,
    alpha: int,
    tighten_sweeps: int = 32,
    telemetry_cap: int = 0,
    use_warm_p: bool = False,
):
    """The slot-stable sharded solve over `mesh`: a function of the
    _SLOT_SOLVE_ARGS (entry tensors as this rank's [Es] blocks, the rest
    whole) and, with use_warm_p, the carried potentials. Same algorithm
    and superstep structure as the single-device slot-stable
    `_solve_mcmf`, so flows, potentials and superstep counts are
    bit-identical to it over the same layout. Returns (flow, p, steps,
    converged, p_overflow[, ring])."""
    D = mesh.size

    def fn(*args):
        if use_warm_p:
            (cap, cost, supply, flow0, eps_init, step_cap,
             s_arc, s_sign, s_src, s_dst, seg_g, isstart,
             inv, node_first_g, node_last_g, node_nonempty, warm_p) = args
        else:
            (cap, cost, supply, flow0, eps_init, step_cap,
             s_arc, s_sign, s_src, s_dst, seg_g, isstart,
             inv, node_first_g, node_last_g, node_nonempty) = args
            warm_p = None
        dev = cap.device
        Es = s_arc.shape[0]
        n = supply.shape[0]
        m = cap.shape[0]
        me = mesh.rank
        base = me * Es
        # ownership re-derived from an arange: the contiguous-range
        # arithmetic of graph/slot_plan.shard_owner
        per = -(-n // D)
        owned = torch.clamp(torch.arange(n, dtype=_I32, device=dev) // per, max=D - 1) == me
        # boundary statics are GLOBAL positions; translate into the local
        # block (owned nodes' regions live in this block by construction;
        # other rows are masked everywhere they feed)
        node_first = torch.clamp(node_first_g.long() - base, 0, Es - 1)  # kschedlint: index-only (gather index)
        node_last = torch.clamp(node_last_g.long() - base, 0, Es - 1)  # kschedlint: index-only (gather index)
        nonempty = node_nonempty.to(torch.bool) & owned
        seg_local = torch.clamp(seg_g.long() - base, 0, Es - 1)  # kschedlint: index-only (gather index)
        # per-arc entry positions: the fwd/bwd halves of inv_order. A
        # position outside this block (or a freed slot's parked 0) maps
        # to the block's dead local slot 0, whose sign is 0
        inv = inv.long()  # kschedlint: index-only (gather index)
        pf_g, pb_g = inv[:m], inv[m:]
        pf = torch.where(pf_g // Es == me, pf_g - base, 0)
        pb = torch.where(pb_g // Es == me, pb_g - base, 0)
        flow, p, steps, conv, p_over, tel = _sharded_mcmf(
            mesh, cap, cost, supply, flow0, eps_init, int(step_cap),
            s_arc, s_sign, s_src, s_dst, seg_local, isstart, None,
            node_first, node_last, nonempty, owned, pf, pb,
            alpha, tighten_sweeps, telemetry_cap, warm_p=warm_p)
        base_out = (flow, p, steps, conv, p_over)
        return base_out + (tel,) if telemetry_cap else base_out

    return fn


# ---------------------------------------------------------------------------
# The fitting gate: when does a graph escalate off the single device?
# ---------------------------------------------------------------------------

#: int32 entry-space vectors the scan-CSR solve holds live across a
#: superstep: the 6 resident entry tables plus ~8 superstep temporaries
_CSR_LIVE_EVECS = 14
#: [N] node-space vectors live per superstep
_CSR_LIVE_NVECS = 8
#: [M] arc-space vectors live per solve
_CSR_LIVE_MVECS = 6

#: the per-device working-set budget for ONE solver's tensors: the JAX
#: package's policy value (1 GiB, sized there for a serving stack that
#: shares the chip), kept so that the gate decides as the JAX package
#: does. It is not a measurement of any device's memory. Overridable
#: per AutoSolver and by KSCHED_HBM_BUDGET.
DEFAULT_HBM_BUDGET_BYTES = 1 << 30


def csr_working_set_bytes(n_cap: int, m_cap: int) -> int:
    """Estimated bytes of the single-device scan-CSR live set for a
    padded (n_cap, m_cap) bucket (entry extent 2*m_cap)."""
    e = 2 * m_cap
    return 4 * (
        _CSR_LIVE_EVECS * e + _CSR_LIVE_NVECS * n_cap + _CSR_LIVE_MVECS * m_cap
    )


def scan_csr_fits_hbm(
    n_cap: int, m_cap: int, budget_bytes: int = DEFAULT_HBM_BUDGET_BYTES
) -> bool:
    """Whether one device's budget holds the scan-CSR working set.
    False is what escalates dispatch to the sharded rung
    (solver/graph_collapse.AutoSolver)."""
    return csr_working_set_bytes(n_cap, m_cap) <= budget_bytes


def sharded_shard_bytes(n_cap: int, m_cap: int, num_shards: int) -> int:
    """Estimated per-shard bytes of the slot-stable sharded working set:
    the entry tables shrink to the block extent, the replicated node and
    arc vectors are paid in full on every shard."""
    es = sharded_entry_extent(m_cap, num_shards)
    return 4 * (
        _CSR_LIVE_EVECS * es + _CSR_LIVE_NVECS * n_cap + _CSR_LIVE_MVECS * m_cap
    )


def sharded_fits_hbm(
    n_cap: int,
    m_cap: int,
    num_shards: int,
    budget_bytes: int = DEFAULT_HBM_BUDGET_BYTES,
) -> bool:
    """Whether the PER-SHARD working set fits the per-device budget."""
    return sharded_shard_bytes(n_cap, m_cap, num_shards) <= budget_bytes


# ---------------------------------------------------------------------------
# Sharded plan maintenance (the device-resident mirror's sharded mode,
# graph/device_export.DeviceResidentState.enable_sharded_plan)
# ---------------------------------------------------------------------------


def sharded_plan_apply_fn(mesh: ShardMesh):  # kschedlint: program=sharded_plan_apply
    """The per-shard routed plan scatter: a round's dirty plan rows and
    relocated segment statics arrive routed to their owner shards
    (`SlotPlanState.drain_records_sharded`: block-local positions, one
    shared pow2 record bucket, idempotent dead-slot pads), and each rank
    applies ITS records to ITS block of the six entry tensors, in
    place. No collective: the routing happened on the host."""

    def apply(p_arc, p_sign, p_src, p_dst, seg, isstart, row_rec, seg_rec):
        """row_rec int32 [D, K, 5] and seg_rec int32 [D, K, 3] on the
        host; this rank uploads and applies its own [K, cols] slice."""
        rows = torch.tensor(row_rec[mesh.rank], dtype=_I32, device=p_arc.device)
        segs = torch.tensor(seg_rec[mesh.rank], dtype=_I32, device=p_arc.device)
        pos = rows[:, 0].long()  # kschedlint: index-only (gather index)
        p_arc.index_copy_(0, pos, rows[:, 1].contiguous())
        p_sign.index_copy_(0, pos, rows[:, 2].contiguous())
        p_src.index_copy_(0, pos, rows[:, 3].contiguous())
        p_dst.index_copy_(0, pos, rows[:, 4].contiguous())
        spos = segs[:, 0].long()  # kschedlint: index-only (gather index)
        seg.index_copy_(0, spos, segs[:, 1].contiguous())
        isstart.index_copy_(0, spos, segs[:, 2] != 0)
        return rows.nbytes + segs.nbytes

    return apply


def replicated_plan_apply_fn():  # kschedlint: program=replicated_plan_apply
    """The replicated remainder of a sharded plan sync: inv-order and
    node-boundary records scattered into the whole (replicated) plan
    tensors on every rank, in place. Returns the bytes uploaded."""

    def apply(inv, first, last, nonempty, inv_rec, node_rec):
        inv_t = torch.tensor(inv_rec, dtype=_I32, device=inv.device)
        node_t = torch.tensor(node_rec, dtype=_I32, device=inv.device)
        inv.index_copy_(0, inv_t[:, 0].long(), inv_t[:, 1].contiguous())  # kschedlint: index-only (index_copy_ positions)
        nid = node_t[:, 0].long()  # kschedlint: index-only (gather index)
        first.index_copy_(0, nid, node_t[:, 1].contiguous())
        last.index_copy_(0, nid, node_t[:, 2].contiguous())
        nonempty.index_copy_(0, nid, node_t[:, 3] != 0)
        return inv_t.nbytes + node_t.nbytes

    return apply


def _block_fp(v: torch.Tensor, offset: int) -> torch.Tensor:
    """One block's weighted partial checksum with GLOBAL-index weights
    (global position = offset + local index, the weights of
    runtime/integrity.host_fingerprint), as an int64 scalar: each
    product is masked to its low 32 bits, and the partial sums stay far
    below 2**63."""
    from ..runtime.integrity import _FP_ADD, _FP_MUL

    x = v.reshape(-1).to(_I32).to(torch.int64)  # kschedlint: disable=dtype64 -- int64 holds the uint32 checksum's masked products
    i = torch.arange(x.shape[0], dtype=torch.int64, device=x.device) + offset  # kschedlint: disable=dtype64 -- int64 global-index weights of the checksum
    w = ((i * _FP_MUL + _FP_ADD) & _MASK32) | 1
    return ((x * w) & _MASK32).sum()  # kschedlint: disable=int32-reduce -- the int64 partial sum the psum combines


def sharded_plan_fingerprint_fn(mesh: ShardMesh):  # kschedlint: program=sharded_plan_fingerprint
    """Per-shard fingerprints combined into ONE comparable checksum per
    plan tensor (the integrity audit, sharded): each rank computes the
    weighted partial sum of its [Es] block with global-index weights,
    the int64 partials are psum'd and masked to 32 bits, which equals
    the host twin of the whole tensor bit for bit. Returns uint32[10] in
    FP_PLAN_ARRAYS order on every rank."""
    from ..runtime.integrity import _device_fp1

    def fp(p_arc, p_sign, p_src, p_dst, inv, seg, isstart, first, last, nonempty):
        es = p_arc.shape[0]
        off = mesh.rank * es
        ent = torch.stack([_block_fp(t, off) for t in
                           (p_arc, p_sign, p_src, p_dst, seg, isstart)])
        ent = mesh.psum(ent, "fingerprint") & _MASK32
        rep = [_device_fp1(x) for x in (inv, first, last, nonempty)]
        # FP_PLAN_ARRAYS order: p_arc, p_sign, p_src, p_dst, inv_order,
        # seg_start, is_start, node_first, node_last, node_nonempty
        out = torch.stack([ent[0], ent[1], ent[2], ent[3], rep[0],
                           ent[4], ent[5], rep[1], rep[2], rep[3]])
        return out.cpu().numpy().astype(np.uint32)

    return fp


def gather_block(mesh: ShardMesh, block: torch.Tensor) -> np.ndarray:
    """The whole [D * Es] tensor from every rank's [Es] block (one
    owner-masked all_gather), on the host: what a parity check or a
    bounded diff of a sharded plan tensor reads."""
    dt = block.dtype
    rows = mesh.all_gather(block.to(_I32), "gather_block")
    return rows.reshape(-1).to(dt).cpu().numpy()


class ShardedJaxSolver(FlowSolver):
    """Push-relabel MCMF sharded over a ShardMesh (the JAX package's
    name, kept). Every rank of the mesh calls `solve` with the same
    problem, in the same order.

    Two dispatch paths, chosen per problem:

    - **slot-stable** (`slot_stable=True` and the problem carries a
      slot-plan handle, as every DeviceGraphState problem does): the
      plan is switched into sharded layout mode and the solve consumes
      the same ten maintained tensors as the single-device CsrSolver,
      each rank holding its own [Es] block of the entry tables. Endpoint
      churn never rebuilds a ShardedPlan: the round's records ride the
      sharded mirror's scatter or the plan's cached upload. Warm flow
      and potentials stay on the device between rounds under the same
      journal-scoped policy as CsrSolver (carried flow only on
      endpoint-clean rounds, prices refit from the carried potentials,
      a budgeted warm attempt escaping to a fresh restart, cost scaling
      as the backstop), so placements stay bit-identical to the
      single-device arm's.
    - **legacy** (plain array problems): the `build_sharded_plan`
      argsort path.
    """

    def __init__(self, mesh: ShardMesh, alpha: int = 8,
                 max_supersteps: int = 50_000, warm_start: bool = True,
                 telemetry: Optional[int] = None, warm_potentials: bool = True,
                 restart_budget: Optional[int] = 64, slot_stable: bool = True,
                 journal_scoped_warm: bool = True):
        self.mesh = mesh
        self.device = mesh.device
        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.warm_start = warm_start
        self.telemetry = telemetry
        self.warm_potentials = warm_potentials
        self.restart_budget = restart_budget
        self.slot_stable = slot_stable
        self.journal_scoped_warm = journal_scoped_warm
        self._plan: Optional[ShardedPlan] = None
        self._plan_dev = None
        self._solve_fn = None
        self._solve_fn_cap = -1  # telemetry_cap the cached fn was built for
        self._prev: Optional[np.ndarray] = None
        # ---- slot-stable path state ----------------------------------
        self._slot_fns = {}  # (telemetry_cap, use_warm_p) -> fn
        self._splan_cache = None  # (layout_gen, value_version, tensors)
        self._prev_dev = None  # carried flow, on the device
        self._prev_p = None  # carried potentials, on the device
        self._prev_src_dev = None  # endpoint tensors at the last success
        self._prev_dst_dev = None
        self._prev_src_host = None  # endpoints at the last SUCCESSFUL solve
        self._prev_dst_host = None
        self._key_solved = None  # plan_key at the last successful solve
        self.last_supersteps = 0
        self.last_telemetry = None
        self.last_warm_scope = "cold"  # warm | fresh | cold
        self.last_path = "legacy"  # legacy | slot_stable (per solve)
        #: bytes this rank copied host -> device in the last solve (the
        #: problem arrays, warm flow and plan blocks it uploaded; 0 for
        #: a resident problem, whose mirror counts its own)
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

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    # -- slot-stable dispatch ----------------------------------------------

    def _slot_fn(self, tel_cap: int, use_warm_p: bool):
        key = (tel_cap, use_warm_p)
        fn = self._slot_fns.get(key)
        if fn is None:
            fn = make_sharded_slot_solver(
                self.mesh, self.alpha, telemetry_cap=tel_cap, use_warm_p=use_warm_p)
            self._slot_fns[key] = fn
        return fn

    def _sharded_plan_args(self, plan_state) -> Tuple:
        """The maintained plan as this rank's tensors (the non-resident
        upload, cached per (layout_gen, value_version))."""
        key = (plan_state.layout_gen, plan_state.value_version)
        if self._splan_cache is None or self._splan_cache[0] != key:
            tensors = place_sharded_plan(
                self.mesh, plan_state.host_args(), self.num_shards,
                plan_state.block_extent)
            self._splan_cache = (key, tensors)
            self.last_upload_bytes += sum(t.nbytes for t in tensors)
        return self._splan_cache[1]

    def _solve_slot_stable(self, problem: FlowProblem, plan_state) -> FlowResult:
        from ..graph.device_export import resident_solver_inputs
        from ..obs import soltel
        from ..solver.base import SolverStallError, check_finite_costs, lower_bound_cost

        n = problem.num_nodes
        m = len(problem.src)
        check_finite_costs(problem)
        max_cost = int(np.abs(problem.cost).max()) if m else 0
        if max_cost * n >= (1 << 30):
            raise OverflowError("scaled costs overflow int32")
        D = self.num_shards
        plan_state.enable_sharding(D)
        plan_state.ensure_built()
        tel_cap = soltel.resolve_cap(self.telemetry)
        self.last_path = "slot_stable"
        dev = self.device

        # the plan tensors: the sharded resident mirror's scatter-
        # maintained blocks when the handle carries them, else this
        # solver's cached upload of the host plan
        d_shard = getattr(problem, "d_plan_shard", None)
        if d_shard is not None:
            plan_dev = d_shard
        else:
            plan_dev = self._sharded_plan_args(plan_state)

        # the journal-scoped warm policy of CsrSolver: carried FLOW only
        # when this round's journal re-wired no endpoints
        plan_key = getattr(problem, "plan_key", None)
        keep_flow = True
        if self.journal_scoped_warm and plan_key is not None:
            keep_flow = (
                self._key_solved is not None and plan_key == self._key_solved
            )
        resident = getattr(problem, "d_cap", None) is not None
        if resident:
            dev_args, flow0_dev, warm = resident_solver_inputs(
                problem, self._prev_dev, self._prev_src_dev,
                self._prev_dst_dev, self.warm_start and keep_flow, dev,
            )
        else:
            cap = problem.cap.astype(np.int32)
            supply = problem.excess.astype(np.int32)
            cost = problem.cost.astype(np.int32) * np.int32(n)
            dev_args = tuple(torch.as_tensor(x, device=dev)
                             for x in (cap, cost, supply))
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
                same = (self._prev_src_host == problem.src) & (
                    self._prev_dst_host == problem.dst
                )
                if self.journal_scoped_warm and plan_key is None and not same.all():
                    warm = False
                else:
                    flow0 = np.where(
                        same, np.minimum(self._prev, cap), 0
                    ).astype(np.int32)
            flow0_dev = torch.as_tensor(flow0, device=dev)
            self.last_upload_bytes += sum(x.nbytes for x in (cap, cost, supply, flow0))
        had_state = self._prev is not None or self._prev_dev is not None
        self.last_warm_scope = (
            "warm" if warm else ("fresh" if had_state else "cold")
        )

        warm_p_ok = (
            self.warm_potentials
            and warm
            and self._prev_p is not None
            and self._prev_p.shape[0] == n
        )
        attempt1_budget = min(4096, self.max_supersteps)
        if warm and self.restart_budget is not None:
            attempt1_budget = min(attempt1_budget, self.restart_budget)
        zeros = torch.zeros(m, dtype=_I32, device=dev)
        # the attempt ladder: warm (budgeted) -> fresh restart (eps=1,
        # zero flow) -> cost scaling from max|cost|*n
        attempts = [(flow0_dev, 1, attempt1_budget, warm_p_ok)]
        if warm:
            attempts.append((zeros, 1, min(4096, self.max_supersteps), False))
        attempts.append(
            (zeros, max(1, max_cost * n), self.max_supersteps, False)
        )
        flow = p = tel_buf = None
        steps = 0
        converged = p_overflow = False
        spent = 0
        for ai, (f0, eps_init, cap_steps, use_wp) in enumerate(attempts):
            fn = self._slot_fn(tel_cap, use_wp)
            args = tuple(dev_args) + (f0, eps_init, cap_steps) + tuple(plan_dev)
            if use_wp:
                args = args + (self._prev_p,)
            out = fn(*args)
            if tel_cap:
                flow, p, steps, converged, p_overflow, tel_buf = out
            else:
                flow, p, steps, converged, p_overflow = out
            spent += int(steps)
            ok = bool(converged) and not bool(p_overflow)
            if ai == 0 and warm and not ok and not bool(converged):
                soltel.warm_price_war(
                    "sharded",
                    supersteps=int(steps),
                    budget=attempt1_budget,
                    escaped_to="fresh_restart",
                    tel=(
                        soltel.decode(
                            tel_buf, int(steps), tel_cap, "sharded",
                            attempt1_budget, converged=False,
                            nodes=n, arcs=m,
                        )
                        if tel_buf is not None
                        else None
                    ),
                )
            if ok:
                break
        self.last_supersteps = spent
        # the ring's budget is the SOLVER's, not the warm attempt's
        self.last_telemetry = (
            soltel.decode(
                tel_buf, int(steps), tel_cap, "sharded", self.max_supersteps,
                converged=bool(converged) and not bool(p_overflow),
                nodes=n, arcs=m,
            )
            if tel_buf is not None
            else None
        )
        if bool(p_overflow) or not bool(converged):
            self.reset()
        if bool(p_overflow):
            raise OverflowError(
                "sharded push-relabel potentials approached int32 range"
            )
        if not bool(converged):
            tel = self.last_telemetry
            raise SolverStallError(
                f"sharded push-relabel did not converge within "
                f"{self.max_supersteps} supersteps; infeasible?",
                reason=soltel.detect_stall(tel) if tel is not None else None,
                telemetry=tel,
            )
        flow_np = flow.cpu().numpy()
        if self.warm_start:
            self._prev = flow_np.astype(np.int32)
            self._prev_dev = flow if resident else None
            self._prev_src_dev = problem.d_src if resident else None
            self._prev_dst_dev = problem.d_dst if resident else None
            self._prev_src_host = np.asarray(problem.src, np.int32)
            self._prev_dst_host = np.asarray(problem.dst, np.int32)
            self._key_solved = plan_key
            self._prev_p = p
        objective = int(
            (flow_np.astype(np.int64) * problem.cost.astype(np.int64)).sum()  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
        ) + lower_bound_cost(problem)
        return FlowResult(flow=flow_np.astype(np.int64), objective=objective,  # kschedlint: host-only (FlowResult's int64 flow)
                          iterations=spent)

    def solve(self, problem: FlowProblem) -> FlowResult:
        self.last_upload_bytes = 0
        m = len(problem.src)
        if m == 0 or problem.num_arcs == 0:
            if (problem.excess > 0).any():
                raise RuntimeError("infeasible flow problem: supply but no arcs")
            self.last_telemetry = None
            return FlowResult(flow=np.zeros(m, dtype=np.int64), objective=0, iterations=0)  # kschedlint: host-only (FlowResult's int64 flow)
        plan_state = getattr(problem, "plan", None) if self.slot_stable else None
        if plan_state is not None:
            return self._solve_slot_stable(problem, plan_state)
        return self._solve_legacy(problem)

    def _solve_legacy(self, problem: FlowProblem) -> FlowResult:
        from ..obs import soltel
        from ..solver.base import SolverStallError

        self.last_path = "legacy"
        n = problem.num_nodes
        m = len(problem.src)
        src = problem.src.astype(np.int32)
        dst = problem.dst.astype(np.int32)
        cap = problem.cap.astype(np.int32)
        supply = problem.excess.astype(np.int32)
        max_cost = int(np.abs(problem.cost).max()) if m else 0
        if max_cost * n >= (1 << 30):
            raise OverflowError("scaled costs overflow int32")
        cost = problem.cost.astype(np.int32) * np.int32(n)
        dev = self.device

        tel_cap = soltel.resolve_cap(self.telemetry)
        prev_plan = self._plan
        plan = prev_plan
        if plan is None or len(plan.src) != m or plan.node_first.shape[1] != n or not (
            np.array_equal(plan.src, src) and np.array_equal(plan.dst, dst)
        ):
            plan = build_sharded_plan(src, dst, n, self.num_shards)
            self._plan = plan
            self._plan_dev = plan.shard_tensors(self.mesh.rank, dev)
            self.last_upload_bytes += sum(t.nbytes for t in self._plan_dev)
        if self._solve_fn is None or self._solve_fn_cap != tel_cap:
            self._solve_fn = make_sharded_solver(self.mesh, self.alpha,
                                                 telemetry_cap=tel_cap)
            self._solve_fn_cap = tel_cap

        flow0 = np.zeros(m, dtype=np.int32)
        if (
            self.warm_start
            and self._prev is not None
            and len(self._prev) == m
            and prev_plan is not None
            and len(prev_plan.src) == m
        ):
            # against the endpoints the previous flow was solved for
            # (prev_plan), not the freshly rebuilt plan
            same = (prev_plan.src == src) & (prev_plan.dst == dst)
            flow0 = np.where(same, np.minimum(self._prev, cap), 0).astype(np.int32)

        attempts = [
            (flow0, 1, min(4096, self.max_supersteps)),
            (np.zeros(m, dtype=np.int32), max(1, max_cost * n), self.max_supersteps),
        ]
        flow = tel_buf = None
        steps = 0
        budget = self.max_supersteps
        converged = p_overflow = False
        base_args = tuple(torch.as_tensor(x, device=dev) for x in (cap, cost, supply))
        self.last_upload_bytes += sum(x.nbytes for x in (cap, cost, supply))
        for f0, eps_init, cap_steps in attempts:
            out = self._solve_fn(
                *base_args, torch.as_tensor(f0, device=dev), eps_init,
                cap_steps, *self._plan_dev,
            )
            self.last_upload_bytes += f0.nbytes
            if tel_cap:
                flow, steps, converged, p_overflow, tel_buf = out
            else:
                flow, steps, converged, p_overflow = out
            budget = cap_steps
            if bool(converged) and not bool(p_overflow):
                break
        self.last_supersteps = int(steps)
        self.last_telemetry = (
            soltel.decode(
                tel_buf, int(steps), tel_cap, "sharded", budget,
                converged=bool(converged) and not bool(p_overflow),
                nodes=n, arcs=m,
            )
            if tel_buf is not None
            else None
        )
        if bool(p_overflow) or not bool(converged):
            self._prev = None
        if bool(p_overflow):
            raise OverflowError("sharded push-relabel potentials approached int32 range")
        if not bool(converged):
            tel = self.last_telemetry
            raise SolverStallError(
                "sharded push-relabel did not converge; infeasible?",
                reason=soltel.detect_stall(tel) if tel is not None else None,
                telemetry=tel,
            )
        flow_np = flow.cpu().numpy()
        if self.warm_start:
            self._prev = flow_np.astype(np.int32)
        objective = int(
            (flow_np.astype(np.int64) * problem.cost.astype(np.int64)).sum()  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
            + (problem.flow_offset.astype(np.int64) * problem.cost.astype(np.int64)).sum()  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
        )
        return FlowResult(flow=flow_np.astype(np.int64), objective=objective,  # kschedlint: host-only (FlowResult's int64 flow)
                          iterations=int(steps))


from ..analysis.program_registry import declare_programs as _declare_programs  # noqa: E402

_declare_programs(
    __name__,
    "sharded_solve",
    "sharded_slot_solve",
    "sharded_slot_solve_warmp",
    "sharded_plan_apply",
    "replicated_plan_apply",
    "sharded_plan_fingerprint",
)
