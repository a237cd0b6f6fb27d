"""Multi-device layered transport: the dense solve with its machine
columns sharded over a ShardMesh.

Port of ksched_tpu/parallel/sharded_transport.py. The machine axis of
the dense transport problem (solver/layered.py) is split across the
mesh's ranks and the per-superstep combination of row and sink state
rides collectives:

- machine columns [C, Mloc] (costs, capacities, flows y, prices pm) are
  rank-local; Mp is a multiple of 128 * D so every rank holds the same
  number of columns;
- row state (supplies, row prices pr, the sink price, the eps phase) is
  replicated, and each superstep reconciles it with one psum or pmax
  per reduction, [C]-sized payloads;
- the rows' maximal-push allocation needs an exclusive prefix over the
  GLOBAL column order: the two-level scan of mesh.global_excl_prefix.
  Global column order equals the unsharded order, so the sharded solve
  is bit-identical, superstep for superstep, to the single-device solve
  (kernel B1 on the card, `_solve_transport` on the CPU).

The JAX package runs this as an XLA program under shard_map; here it is
plain PyTorch on each rank's device, one host read of the replicated
"any node active" flag per superstep. Every rank computes that flag
from all-reduced values, so every rank leaves the loop on the same
superstep and issues the same collectives in the same order.
"""

from __future__ import annotations

import torch

from ..analysis.marks import loop_mark

from ..solver.layered import (
    BIG,
    BIG_D,
    LayeredProblem,
    LayeredResult,
    pad_geometry,
    solve_layered_host,
    transport_saturate,
    transport_saturate_eps_tiered,
    validate_alpha,
)
from .mesh import ShardMesh, global_excl_prefix

_I32 = torch.int32


def _clip(x, hi):
    """jnp.clip(x, 0, hi) for int32 tensors."""
    return torch.minimum(torch.clamp(x, min=0), hi)


def _local_cols(mesh: ShardMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last (column) axis."""
    mloc = x.shape[-1] // mesh.size
    return x[..., mesh.rank * mloc:(mesh.rank + 1) * mloc].contiguous()


def _gather_cols(mesh: ShardMesh, y_local: torch.Tensor) -> torch.Tensor:
    """[C, Mloc] on every rank -> the global [C, D * Mloc]."""
    parts = mesh.all_gather(y_local, "gather_y")  # [D, C, Mloc]
    return parts.permute(1, 0, 2).reshape(y_local.shape[0], -1)


def _excesses(mesh, supply, y, z):
    e_row = supply - mesh.psum(y.sum(dim=1, dtype=_I32), "excess")  # [C] repl
    e_col = y.sum(dim=0, dtype=_I32) - z  # [Mloc] local
    e_sink = mesh.psum(z.sum(dtype=_I32), "excess") - supply.sum(dtype=_I32)
    return e_row, e_col, e_sink


def _cold_tighten(mesh, w, U, col_cap):
    """The cold start's potentials over the mesh: pr = the global max
    over live arcs of -w, psink = the global min over live columns."""
    live = col_cap > 0
    pm0 = torch.where(live, torch.zeros_like(col_cap), -BIG_D)
    pr0 = mesh.pmax(torch.where(U > 0, pm0[None, :] - w, -BIG_D).amax(dim=1),
                    "tighten")
    has_arc = mesh.psum((U > 0).sum(dim=1, dtype=_I32), "tighten") > 0
    pr0 = torch.where(has_arc, pr0, 0)
    psink0 = mesh.pmin(torch.where(live, pm0, BIG_D).amin(), "tighten")
    n_live = mesh.psum(live.sum(dtype=_I32), "tighten")
    psink0 = torch.where(n_live > 0, psink0, 0)
    return pr0, pm0, psink0


def _phase_loop(mesh, supply, col_cap, C, Mloc, pr, pm, psink, eps0, alpha,
                max_supersteps, superstep, next_phase):
    """The cost-scaling phase schedule shared by both solves: a
    superstep while any node is active, else the next eps phase, until
    the eps=1 phase drains or max_supersteps. Returns (y_local, steps,
    converged)."""
    dev = col_cap.device
    y = torch.zeros((C, Mloc), dtype=_I32, device=dev)
    z = torch.zeros(Mloc, dtype=_I32, device=dev)
    eps, steps, done = int(eps0), 0, False
    while not done and steps < max_supersteps:
        loop_mark("superstep")
        e_row, e_col, e_sink = _excesses(mesh, supply, y, z)
        # every term is computed on every rank (the psum always runs),
        # so the collective sequence never depends on a short circuit
        col_active = mesh.any(e_col > 0, "active")
        if bool((e_row > 0).any() | col_active | (e_sink > 0)):
            y, z, pr, pm, psink = superstep(y, z, pr, pm, psink, eps,
                                            e_row, e_col, e_sink)
            steps += 1
        elif eps <= 1:
            done = True
        else:
            eps = max(1, eps // alpha)
            y, z, pr, pm, psink = next_phase(y, z, pr, pm, psink, eps)
    loop_mark()
    e_row, e_col, e_sink = _excesses(mesh, supply, y, z)
    max_abs = torch.maximum(
        torch.maximum(e_row.abs().amax(), e_sink.abs()),
        mesh.pmax(e_col.abs().amax(), "final"),
    )
    converged = done and int(max_abs) == 0
    return y, steps, converged


def sharded_transport_solve(mesh: ShardMesh, wS, supply, col_cap, eps0,
                            alpha: int = 8, max_supersteps: int = 1 << 17):
    """Solve the padded transport problem with machine columns sharded
    over `mesh`. wS int32[C, Mp], supply int32[C], col_cap int32[Mp] are
    the whole problem on every rank (each takes its own column block);
    Mp must be divisible by the mesh size. Returns (y [C, Mp] on every
    rank, steps int, converged bool), bit-identical to the
    single-device solve."""
    C, Mp = wS.shape
    if Mp % mesh.size:
        raise ValueError(f"Mp={Mp} is not divisible by the mesh size {mesh.size}")
    w = _local_cols(mesh, wS)
    cap = _local_cols(mesh, col_cap)
    U = torch.minimum(supply[:, None], cap[None, :])

    def superstep(y, z, pr, pm, psink, eps, e_row, e_col, e_sink):
        rcf = w + pr[:, None] - pm[None, :]
        # rows push forward: global in-row exclusive prefix (two-level)
        r_fwd = U - y
        r_adm = torch.where((r_fwd > 0) & (rcf < 0), r_fwd, 0)
        excl = global_excl_prefix(mesh, r_adm, "superstep")
        delta_f = _clip(e_row[:, None] - excl, r_adm)
        # columns push: sink entry first, then backward col->row, all
        # column-local given the replicated pr and psink
        r_s = cap - z
        adm_s = torch.where((r_s > 0) & (pm - psink < 0), r_s, 0)
        rc_b = pm[None, :] - pr[:, None] - w
        adm_b = torch.where((y > 0) & (rc_b < 0), y, 0)
        excl_b = adm_s[None, :] + (torch.cumsum(adm_b, 0, dtype=_I32) - adm_b)
        delta_s = _clip(e_col, adm_s)
        delta_b = _clip(e_col[None, :] - excl_b, adm_b)
        # the sink pushes back along sharded columns: global prefix again
        zb_adm = torch.where((z > 0) & (psink - pm < 0), z, 0)
        excl_zb = global_excl_prefix(mesh, zb_adm, "superstep")
        delta_zb = _clip(e_sink - excl_zb, zb_adm)
        y2 = y + delta_f - delta_b
        z2 = z + delta_s - delta_zb
        # jump relabels; row and sink candidates combine over the mesh
        pushed_row = mesh.psum(delta_f.sum(dim=1, dtype=_I32), "superstep")
        best_row = mesh.pmax(
            torch.where(r_fwd > 0, pm[None, :] - w, -BIG).amax(dim=1), "superstep")
        pr2 = torch.where((e_row > 0) & (pushed_row == 0), best_row - eps, pr)
        pushed_col = delta_s + delta_b.sum(dim=0, dtype=_I32)
        cand_col = torch.maximum(
            torch.where(y > 0, pr[:, None] + w, -BIG).amax(dim=0),
            torch.where(r_s > 0, psink, -BIG),
        )
        pm2 = torch.where((e_col > 0) & (pushed_col == 0), cand_col - eps, pm)
        pushed_sink = mesh.psum(delta_zb.sum(dtype=_I32), "superstep")
        cand_sink = mesh.pmax(torch.where(z > 0, pm, -BIG).amax(), "superstep")
        psink2 = torch.where((e_sink > 0) & (pushed_sink == 0),
                             cand_sink - eps, psink)
        return y2, z2, pr2, pm2, psink2

    def next_phase(y, z, pr, pm, psink, eps):
        # column-local, no collectives
        y2, z2 = transport_saturate(w, U, cap, y, z, pr, pm, psink)
        return y2, z2, pr, pm, psink

    pr, pm, psink = _cold_tighten(mesh, w, U, cap)
    y, steps, converged = _phase_loop(
        mesh, supply, cap, C, w.shape[1], pr, pm, psink, eps0, alpha,
        max_supersteps, superstep, next_phase)
    return _gather_cols(mesh, y), steps, converged


def sharded_transport_solve_tiered(mesh: ShardMesh, wLo, wHi, R, supply,
                                   col_cap, eps0, alpha: int = 8,
                                   max_supersteps: int = 1 << 17,
                                   refine_waves: int = 0):
    """Tiered (preemption-on) transport with machine columns sharded
    over `mesh`: the multi-device form of the keep-arcs re-solve.
    wLo/wHi/R int32[C, Mp] whole on every rank; Mp divisible by the
    mesh size. Returns (y [C, Mp], steps, converged), bit-identical to
    the single-device tiered solve at equal refine_waves (each
    refinement wave costs two pmin reductions)."""
    C, Mp = wLo.shape
    if Mp % mesh.size:
        raise ValueError(f"Mp={Mp} is not divisible by the mesh size {mesh.size}")
    lo = _local_cols(mesh, wLo)
    hi = _local_cols(mesh, wHi)
    cap = _local_cols(mesh, col_cap)
    U = torch.minimum(supply[:, None], cap[None, :])
    Rl = torch.minimum(_local_cols(mesh, R), U)

    def price_refine(y, z, pr, pm, psink, eps):
        """The tiered refinement over the mesh: bound_m is column-local,
        bound_r and bound_s are global column minima, one pmin each."""
        yA = torch.minimum(y, Rl)
        yB = y - yA
        for _ in range(refine_waves):
            loop_mark("wave")
            bound_m = torch.minimum(
                torch.where(Rl - yA > 0, lo + pr[:, None] + eps, BIG).amin(dim=0),
                torch.where((U - Rl) - yB > 0, hi + pr[:, None] + eps,
                            BIG).amin(dim=0),
            )
            pm2 = torch.clamp(torch.minimum(pm, bound_m), min=-BIG_D)
            pm2 = torch.minimum(pm2, torch.where(z > 0, psink + eps, BIG))
            bound_r = mesh.pmin(torch.minimum(
                torch.where(yA > 0, pm2[None, :] - lo + eps, BIG).amin(dim=1),
                torch.where(yB > 0, pm2[None, :] - hi + eps, BIG).amin(dim=1),
            ), "refine")
            pr2 = torch.clamp(torch.minimum(pr, bound_r), min=-BIG_D)
            bound_s = mesh.pmin(
                torch.where(cap - z > 0, pm2 + eps, BIG).amin(), "refine")
            psink2 = torch.clamp(torch.minimum(psink, bound_s), min=-BIG_D)
            pr, pm, psink = pr2, pm2, psink2
        loop_mark()
        return pr, pm, psink

    def superstep(y, z, pr, pm, psink, eps, e_row, e_col, e_sink):
        yA = torch.minimum(y, Rl)
        yB = y - yA
        rcl = lo + pr[:, None] - pm[None, :]
        rch = hi + pr[:, None] - pm[None, :]
        # rows push forward: both tiers' admissible residuals, one
        # global in-row exclusive prefix
        rA = Rl - yA
        rB = (U - Rl) - yB
        r_adm = (torch.where((rA > 0) & (rcl < 0), rA, 0)
                 + torch.where((rB > 0) & (rch < 0), rB, 0))
        excl = global_excl_prefix(mesh, r_adm, "superstep")
        delta_f = _clip(e_row[:, None] - excl, r_adm)
        # columns push: sink entry, then dear-tier returns, then cheap,
        # column-local given the replicated pr and psink
        r_s = cap - z
        adm_s = torch.where((r_s > 0) & (pm - psink < 0), r_s, 0)
        rcb_hi = pm[None, :] - pr[:, None] - hi
        rcb_lo = pm[None, :] - pr[:, None] - lo
        adm_bh = torch.where((yB > 0) & (rcb_hi < 0), yB, 0)
        adm_bl = torch.where((yA > 0) & (rcb_lo < 0), yA, 0)
        excl_bh = adm_s[None, :] + (torch.cumsum(adm_bh, 0, dtype=_I32) - adm_bh)
        excl_bl = (adm_s + adm_bh.sum(dim=0, dtype=_I32))[None, :] + (
            torch.cumsum(adm_bl, 0, dtype=_I32) - adm_bl)
        delta_s = _clip(e_col, adm_s)
        delta_b = (_clip(e_col[None, :] - excl_bh, adm_bh)
                   + _clip(e_col[None, :] - excl_bl, adm_bl))
        # the sink pushes back along sharded columns: global prefix
        zb_adm = torch.where((z > 0) & (psink - pm < 0), z, 0)
        excl_zb = global_excl_prefix(mesh, zb_adm, "superstep")
        delta_zb = _clip(e_sink - excl_zb, zb_adm)
        y2 = y + delta_f - delta_b
        z2 = z + delta_s - delta_zb
        # jump relabels: candidates consider both tiers' residuals; the
        # two tiers' local maxima combine first, then one pmax
        pushed_row = mesh.psum(delta_f.sum(dim=1, dtype=_I32), "superstep")
        cand_row = mesh.pmax(torch.maximum(
            torch.where(rA > 0, pm[None, :] - lo, -BIG).amax(dim=1),
            torch.where(rB > 0, pm[None, :] - hi, -BIG).amax(dim=1),
        ), "superstep")
        pr2 = torch.where((e_row > 0) & (pushed_row == 0), cand_row - eps, pr)
        pushed_col = delta_s + delta_b.sum(dim=0, dtype=_I32)
        cand_col = torch.maximum(
            torch.maximum(
                torch.where(yA > 0, pr[:, None] + lo, -BIG).amax(dim=0),
                torch.where(yB > 0, pr[:, None] + hi, -BIG).amax(dim=0),
            ),
            torch.where(r_s > 0, psink, -BIG),
        )
        pm2 = torch.where((e_col > 0) & (pushed_col == 0), cand_col - eps, pm)
        pushed_sink = mesh.psum(delta_zb.sum(dtype=_I32), "superstep")
        cand_sink = mesh.pmax(torch.where(z > 0, pm, -BIG).amax(), "superstep")
        psink2 = torch.where((e_sink > 0) & (pushed_sink == 0),
                             cand_sink - eps, psink)
        return y2, z2, pr2, pm2, psink2

    def next_phase(y, z, pr, pm, psink, eps):
        # column-local apart from the refinement's pmins
        if refine_waves:
            pr, pm, psink = price_refine(y, z, pr, pm, psink, eps)
        y2, z2 = transport_saturate_eps_tiered(
            lo, hi, Rl, U, cap, y, z, pr, pm, psink,
            eps if refine_waves else 0)
        return y2, z2, pr, pm, psink

    # cold tighten against the CHEAP tier (wLo <= wHi cellwise)
    pr, pm, psink = _cold_tighten(mesh, lo, U, cap)
    y, steps, converged = _phase_loop(
        mesh, supply, cap, C, lo.shape[1], pr, pm, psink, eps0, alpha,
        max_supersteps, superstep, next_phase)
    return _gather_cols(mesh, y), steps, converged


class ShardedLayeredSolver:
    """Drop-in layered backend (BulkCluster's `solve_layered` seam) that
    runs the multi-class solve with its columns sharded over a
    ShardMesh. Single-class, class-degenerate and row-constant
    instances take the exact host closed forms, as the single-device
    solver does. Every rank of the mesh calls `solve_layered` with the
    same problem."""

    def __init__(self, mesh: ShardMesh, alpha: int = 8,
                 max_supersteps: int = 1 << 17):
        self.mesh = mesh
        self.alpha = validate_alpha(alpha)
        self.max_supersteps = max_supersteps
        self.last_supersteps = 0
        self.last_telemetry = None

    def reset(self) -> None:
        pass

    def _pad_geometry(self, M: int, C: int):
        Mp, n_scale = pad_geometry(M, C)
        d = self.mesh.size
        Mp = -(-Mp // (128 * d)) * 128 * d  # divisible by the mesh size
        return Mp, n_scale

    def solve_layered(self, lp: LayeredProblem) -> LayeredResult:
        def solve(wS, sup, cap, eps_init):
            return sharded_transport_solve(
                self.mesh, wS, sup, cap, eps_init,
                alpha=self.alpha, max_supersteps=self.max_supersteps,
            )

        try:
            res = solve_layered_host(
                lp, pad=self._pad_geometry, solve=solve,
                max_supersteps=self.max_supersteps, device=self.mesh.device,
            )
        except RuntimeError:
            self.last_supersteps = self.max_supersteps  # budget exhausted
            raise
        self.last_supersteps = res.supersteps
        return res


__all__ = [
    "ShardedLayeredSolver",
    "sharded_transport_solve",
    "sharded_transport_solve_tiered",
]
