"""Numpy step-by-step replica of the transport superstep loop, for
inspecting the dynamics of tail rounds (what are 5000 supersteps
doing?). It mirrors solver/layered.py's `transport_superstep` and
`_transport_loop`; its objective equals the plain transport solve's.

The per-step counters are solver-telemetry rows in obs/soltel.py's
`SOLTEL_COLS` order, the rows the solves' rings hold, rendered through
the one convergence-table view (tools/obs_report.py
`report_convergence`). `--out` writes a `solver_telemetry` JSON that
obs_report renders. The replica runs on the host: it needs no card.

Usage:
  python -m ksched_tpu_torch.tools.superstep_trace --inst tails.npz \\
      --k 0 [--table] [--out trace.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ..analysis.marks import loop_mark
from ..obs.soltel import SOLTEL_COLS, SOLTEL_WIDTH

BIG = np.int64(1 << 30)
BIG_D = np.int64(1 << 28)


def excesses(supply, y, z):
    e_row = supply - y.sum(axis=1)
    e_col = y.sum(axis=0) - z
    e_sink = z.sum() - supply.sum()
    return e_row, e_col, e_sink


def tighten(wS, U, col_cap):
    live = col_cap > 0
    pm = np.where(live, 0, -BIG_D)
    has_arc = U > 0
    pr = np.max(np.where(has_arc, pm[None, :] - wS, -BIG), axis=1)
    pr = np.where(has_arc.any(axis=1), pr, 0)
    psink = np.min(np.where(live, pm, BIG))
    return pr, pm, psink


def saturate_eps(wS, U, col_cap, y, z, pr, pm, psink, eps):
    rcf = wS + pr[:, None] - pm[None, :]
    y2 = np.where(rcf < -eps, U, np.where(rcf > eps, 0, y))
    rcs = pm - psink
    z2 = np.where(rcs < -eps, col_cap, np.where(rcs > eps, 0, z))
    return y2, z2


def price_refine(wS, U, col_cap, y, z, pr, pm, psink, eps, waves):
    for _ in range(waves):
        loop_mark("wave")
        bound_m = np.min(np.where(U - y > 0, wS + pr[:, None] + eps, BIG), axis=0)
        pm2 = np.maximum(np.minimum(pm, bound_m), -BIG_D)
        pm2 = np.minimum(pm2, np.where(z > 0, psink + eps, BIG))
        bound_r = np.min(np.where(y > 0, pm2[None, :] - wS + eps, BIG), axis=1)
        pr2 = np.maximum(np.minimum(pr, bound_r), -BIG_D)
        bound_s = np.min(np.where(col_cap - z > 0, pm2 + eps, BIG))
        psink2 = np.maximum(np.minimum(psink, bound_s), -BIG_D)
        pr, pm, psink = pr2, pm2, psink2
    loop_mark()
    return pr, pm, psink


def superstep(wS, U, supply, col_cap, y, z, pr, pm, psink, eps, rows=None):
    """One synchronous wave, the numpy twin of layered.py's
    transport_superstep with its counters: when `rows` is given, one
    SOLTEL_COLS-ordered row is appended per call."""
    e_row, e_col, e_sink = excesses(supply, y, z)
    rcf = wS + pr[:, None] - pm[None, :]

    r_fwd = U - y
    adm_f = (r_fwd > 0) & (rcf < 0)
    r_adm = np.where(adm_f, r_fwd, 0)
    excl = np.cumsum(r_adm, axis=1) - r_adm
    delta_f = np.clip(e_row[:, None] - excl, 0, r_adm)

    r_s = col_cap - z
    rc_s = pm - psink
    r_b = y
    rc_b = pm[None, :] - pr[:, None] - wS
    colA = np.concatenate(
        [np.where((r_s > 0) & (rc_s < 0), r_s, 0)[None, :],
         np.where((r_b > 0) & (rc_b < 0), r_b, 0)], axis=0)
    exclA = np.cumsum(colA, axis=0) - colA
    deltaA = np.clip(e_col[None, :] - exclA, 0, colA)
    delta_s = deltaA[0]
    delta_b = deltaA[1:]

    r_zb = z
    rc_zb = psink - pm
    zb_adm = np.where((r_zb > 0) & (rc_zb < 0), r_zb, 0)
    excl_zb = np.cumsum(zb_adm) - zb_adm
    delta_zb = np.clip(e_sink - excl_zb, 0, zb_adm)

    y2 = y + delta_f - delta_b
    z2 = z + delta_s - delta_zb

    pushed_row = delta_f.sum(axis=1)
    cand_row = np.where(r_fwd > 0, pm[None, :] - wS, -BIG)
    best_row = cand_row.max(axis=1)
    relabel_row = (e_row > 0) & (pushed_row == 0)
    pr2 = np.where(relabel_row, best_row - eps, pr)

    pushed_col = delta_s + delta_b.sum(axis=0)
    cand_col = np.maximum(
        np.max(np.where(y > 0, pr[:, None] + wS, -BIG), axis=0),
        np.where(r_s > 0, psink, -BIG))
    relabel_col = (e_col > 0) & (pushed_col == 0)
    pm2 = np.where(relabel_col, cand_col - eps, pm)

    pushed_sink = delta_zb.sum()
    cand_sink = np.max(np.where(z > 0, pm, -BIG))
    relabel_sink = (e_sink > 0) & (pushed_sink == 0)
    psink2 = np.where(relabel_sink, cand_sink - eps, psink)

    if rows is not None:
        # SOLTEL_COLS order: eps, active, excess, pushed, relabels,
        # saturated, work (layered.py's ring counters)
        rows.append([
            int(eps),
            int((e_row > 0).sum() + (e_col > 0).sum() + (e_sink > 0)),
            int(np.maximum(e_row, 0).sum() + np.maximum(e_col, 0).sum()
                + max(int(e_sink), 0)),
            int(delta_f.sum() + deltaA.sum() + delta_zb.sum()),
            int(relabel_row.sum() + relabel_col.sum() + int(relabel_sink)),
            int(((U > 0) & (y >= U)).sum()
                + ((col_cap > 0) & (z >= col_cap)).sum()),
            int((r_adm > 0).sum() + (colA > 0).sum() + (zb_adm > 0).sum()),
        ] + [0] * (SOLTEL_WIDTH - 7))
    return y2, z2, pr2, pm2, np.int64(psink2)


def run(wS, supply, col_cap, eps_sched, refine_waves=8, verbose_every=500,
        max_steps=40000, log=print):
    """Returns (y, z, rows, converged): rows is the full SOLTEL_COLS
    trace; converged is False when a PHASE exceeded max_steps (the
    budget is per phase: a slow multi-phase instance whose every phase
    drains is not a stall)."""
    U = np.minimum(supply[:, None], col_cap[None, :]).astype(np.int64)
    pr, pm, psink = tighten(wS, U, col_cap)
    C, Mp1 = wS.shape
    y = np.zeros((C, Mp1), np.int64)
    z = np.zeros(Mp1, np.int64)
    rows: list = []
    for phase, eps in enumerate(eps_sched):
        if refine_waves and phase > 0:
            pr, pm, psink = price_refine(wS, U, col_cap, y, z, pr, pm, psink,
                                         eps, refine_waves)
        y, z = saturate_eps(wS, U, col_cap, y, z, pr, pm, psink,
                            0 if phase == 0 else eps)
        k = 0
        while True:
            loop_mark("superstep")
            er, ec, es = excesses(supply, y, z)
            if not (er > 0).any() and not (ec > 0).any() and es <= 0:
                break
            y, z, pr, pm, psink = superstep(wS, U, supply, col_cap, y, z,
                                            pr, pm, psink, eps, rows)
            k += 1
            if verbose_every and k % verbose_every == 0:
                log(f"  eps={eps} step {k}: {dict(zip(SOLTEL_COLS, rows[-1]))}")
            if k > max_steps:
                loop_mark()
                log("  STALL")
                return y, z, rows, False
        loop_mark()
        if k:
            log(f"phase eps={eps}: {k} steps, "
                f"{sum(r[3] for r in rows[-k:])} unit-pushes, final excess drained")
    return y, z, rows, True


def rows_to_telemetry(rows, budget: int, converged: bool = True) -> dict:
    """The tracer's rows as a `solver_telemetry` dict, the shape
    SolveTelemetry.to_dict() gives, for obs_report's convergence view."""
    return {
        "backend": "superstep_trace",
        "steps": len(rows),
        "budget": budget,
        "cap": len(rows),
        "truncated": False,
        "start_step": 0,
        "converged": converged,
        "cols": list(SOLTEL_COLS),
        "rows": [[int(v) for v in row] for row in rows],
    }


def eps_schedule(eps0: int, alpha: int) -> list:
    """eps0, eps0 // alpha, ... down to 1."""
    sched = []
    e = eps0
    while True:
        sched.append(e)
        if e <= 1:
            break
        e = max(1, e // alpha)
    return sched


def trace_instance(data, k: int, n_scale: int = 1024, eps0=None, alpha: int = 8,
                   refine: int = 8, every: int = 500, log=print):
    """Trace instance `k` of a tail_repro npz (`data`, np.load's).
    Returns (objective, placed, telemetry dict)."""
    from ..solver.layered import default_eps0

    Mp = int(data["Mp"])
    w = data[f"w_{k}"].astype(np.int64)
    supply = data[f"supply_{k}"].astype(np.int64)
    col_cap = data[f"colcap_{k}"].astype(np.int64)
    C, M = w.shape
    wP = np.zeros((C, Mp), np.int64)
    wP[:, :M] = w
    wS = wP * n_scale
    sched = eps_schedule(eps0 if eps0 is not None else default_eps0(n_scale), alpha)
    log(f"instance {k}: supply={supply.tolist()} "
        f"cap={int(col_cap[:M].sum())} sched={sched}")
    y, _z, rows, converged = run(wS, supply, col_cap, sched, refine_waves=refine,
                                 verbose_every=every, log=log)
    obj = int((y[:, :M] * wP[:, :M]).sum())
    placed = int(y[:, :M].sum())
    log(f"total steps={len(rows)} obj={obj} placed={placed}"
        + ("" if converged else "  NOT CONVERGED (phase budget blown)"))
    return obj, placed, rows_to_telemetry(rows, budget=40000, converged=converged)


def main(argv=None, log=print) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.superstep_trace")
    ap.add_argument("--inst", default="tails.npz")
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--n-scale", type=int, default=1024)
    ap.add_argument("--eps0", type=int, default=None)
    ap.add_argument("--alpha", type=int, default=8)
    ap.add_argument("--refine", type=int, default=8)
    ap.add_argument("--every", type=int, default=500)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the trace as solver_telemetry JSON "
                    "(tools/obs_report.py renders it)")
    ap.add_argument("--table", action="store_true",
                    help="print the per-superstep convergence table "
                    "(last 64 rows) through obs_report.report_convergence")
    args = ap.parse_args(argv)
    _obj, _placed, tel = trace_instance(
        np.load(args.inst), args.k, n_scale=args.n_scale, eps0=args.eps0,
        alpha=args.alpha, refine=args.refine, every=args.every, log=log)
    if args.table:
        from .obs_report import report_convergence

        report_convergence(tel, max_rows=64, log=log)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"solver_telemetry": tel}, f)
        log(f"telemetry -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
