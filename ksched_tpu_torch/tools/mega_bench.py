"""Microbench: kernel B3 (the general-graph MCMF kernel) against the
scan-based general solves (CSR and ELL) on the 10k x 1k general graph.

The port of ksched_tpu's tools/mcmf_mega_bench.py (its `_solve_fns` at
:39-139, `run_bench` at :142-211): the three solves on the same
instance with the same protocol as tools/csr_bench.py — cold solves
(flow zeroed, eps = 1, prices tightened: the from-scratch solve the
graph path issues per round), each closed by one synchronize, plan
builds outside the clock. B3 is `ops.mcmf_solve` (ops/mcmf.py): the
kernel on the card; on the CPU the plain B3 (`mcmf_loop_plain`) runs,
and the record marks the kernel's time on the card unmeasured instead
of extrapolating from it. `CsrSolver`'s and `EllSolver`'s solves are
solver/csr_solver.py `_solve_mcmf` and solver/ell_solver.py
`_solve_mcmf_ell`. The instance is the host BulkCluster's flow graph
at 10k tasks on 1k machines x 4 PUs x 4 slots (the JAX package's
`__graft_entry__._build_problem`, copied as `build_problem`).

Importable seam: `python -m ksched_tpu_torch.bench --config mcmf-mega`
calls `run_bench`.

Usage: python -m ksched_tpu_torch.tools.mega_bench [--device cpu]
           [--tasks N] [--machines M] [--solves S] [--backends mega,csr,ell]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from ..utils.device import resolve_device

KNOWN = ("mega", "csr", "ell")


def build_problem(num_machines=1000, pus=4, slots=4, jobs=10, tasks=10_000, seed=0):
    """The flow graph of a host BulkCluster holding `tasks` tasks of
    `jobs` jobs (drawn from default_rng(seed)) on `num_machines` machines
    of `pus` PUs x `slots` slots, before any solve."""
    from ..scheduler.bulk import BulkCluster
    from ..solver.base import FlowResult, FlowSolver

    class _NullSolver(FlowSolver):
        def solve(self, problem):
            return FlowResult(flow=np.zeros(len(problem.src), np.int64), objective=0)  # kschedlint: host-only (host numpy)

    rng = np.random.default_rng(seed)
    cluster = BulkCluster(num_machines=num_machines, pus_per_machine=pus,
                          slots_per_pu=slots, num_jobs=jobs, backend=_NullSolver(),
                          task_capacity=tasks + 4096)
    cluster.add_tasks(tasks, rng.integers(0, jobs, tasks).astype(np.int32))
    return cluster._problem()


def launchers(problem, max_supersteps: int, backends, device) -> dict:
    """name -> (a zero-argument cold-solve launch returning the solve's
    output tensors, without a synchronize; the index of its supersteps
    and of its converged flag in that output), for each requested
    backend over plans built here (outside any clock). "mega" is absent
    when the kernel's fits gate (`ops.mcmf.mega_fits`) refuses the
    graph."""
    from .. import ops
    from ..ops.mcmf import mega_fits
    from ..solver.csr_solver import _solve_mcmf, build_csr_plan
    from ..solver.ell_solver import _solve_mcmf_ell, build_ell_plan, plan_tensors
    from ..solver.mega_solver import build_mega_plan

    dev = resolve_device(device)
    n = problem.num_nodes
    src = problem.src.astype(np.int32)
    dst = problem.dst.astype(np.int32)
    m = len(src)
    cap = torch.as_tensor(problem.cap.astype(np.int32), device=dev)
    cost = torch.as_tensor(problem.cost.astype(np.int32) * np.int32(n), device=dev)
    supply = torch.as_tensor(problem.excess.astype(np.int32), device=dev)
    zero_flow = torch.zeros(m, dtype=torch.int32, device=dev)
    csr_plan = build_csr_plan(src, dst, n)
    out = {}
    if "csr" in backends:
        csr_t = csr_plan.tensors(dev)
        out["csr"] = (lambda: _solve_mcmf(cap, cost, supply, zero_flow, 1, *csr_t, alpha=8,
                                          max_supersteps=max_supersteps), 2, 3)
    if "ell" in backends:
        ell_t = plan_tensors(build_ell_plan(src, dst, n), dev)
        out["ell"] = (lambda: _solve_mcmf_ell(cap, cost, supply, zero_flow, 1, *ell_t,
                                              alpha=8, max_supersteps=max_supersteps), 2, 3)
    if "mega" in backends and mega_fits(2 * m):
        mp = build_mega_plan(csr_plan)
        mega_t = tuple(torch.as_tensor(x, device=dev) for x in (
            mp.e_arc, mp.e_sign, mp.e_src, mp.e_hs, mp.e_he, mp.e_prow, mp.e_pcol,
            mp.fwd_pos))
        out["mega"] = (lambda: ops.mcmf_solve(cap, cost, supply, zero_flow, 1, *mega_t,
                                              mp.R, mp.L, alpha=8,
                                              max_supersteps=max_supersteps), 1, 2)
    return out


def solve_fns(problem, max_supersteps: int, backends, device) -> dict:
    """name -> a zero-argument cold solve closed by one synchronize,
    returning (supersteps, flow int32[M] tensor); raises when the solve
    did not converge (`launchers` says which backends are there)."""
    from ..bench import _sync

    dev = resolve_device(device)

    def closed(name, launch, steps_at, conv_at):
        def run():
            out = launch()
            _sync(dev)
            if not bool(out[conv_at]):
                raise AssertionError(f"{name} solve did not converge")
            return int(out[steps_at]), out[0]

        return run

    return {name: closed(name, *spec)
            for name, spec in launchers(problem, max_supersteps, backends, dev).items()}


def run_bench(tasks=10_000, machines=1_000, solves=8, max_supersteps=4096,
              backends=KNOWN, device="cuda", log=None) -> dict:
    """Time `solves` cold solves of each backend after one warm-up solve
    (the first solve on the card builds the kernel) on `device`: p50 ms
    and supersteps per backend, and the record (bench.py's shape)."""
    dev = resolve_device(device)
    backends = tuple(b.strip() for b in backends)
    for b in backends:
        if b not in KNOWN:
            raise SystemExit(f"unknown backend {b!r}; choose from {KNOWN}")
    problem = build_problem(num_machines=machines, tasks=tasks)
    platform = dev.type
    fns = solve_fns(problem, max_supersteps, backends, dev)
    detail = {
        "nodes": problem.num_nodes,
        "arcs": len(problem.src),
        "entries": 2 * len(problem.src),
        "solves": solves,
        "platform": platform,
    }
    per = {}
    for name in backends:
        if name not in fns:
            # only mega can be absent: the fits gate refused the graph
            detail[name] = "refused (the kernel's L2 budget, ops/mcmf.py mega_fits)"
            continue
        fn = fns[name]
        steps, _ = fn()  # warm-up (the kernel's build on the card), not timed
        walls = []
        for _ in range(solves):
            t0 = time.perf_counter()
            steps, _ = fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        per[name] = {"p50_ms": round(float(np.percentile(walls, 50)), 3),
                     "supersteps": steps}
        if name == "mega" and platform == "cpu":
            per[name]["mode"] = "plain (mcmf_loop_plain on the CPU)"
        if log is not None:
            log(f"# {name}: {per[name]}")
    detail.update(per)
    if "mega" in per and "csr" in per:
        ratio = per["csr"]["p50_ms"] / max(per["mega"]["p50_ms"], 1e-9)
        if platform == "cuda":
            detail["mega_vs_csr_speedup"] = round(ratio, 2)
        else:
            detail["mega_vs_csr_speedup"] = (
                f"{round(ratio, 2)}x with the plain B3 on the CPU — the kernel's "
                "time on the card is UNMEASURED here")
    # headline: the first measured backend in preference order (JSON
    # null when everything was refused or excluded)
    value = next((per[b]["p50_ms"] for b in KNOWN if b in per), None)
    return {
        "metric": (
            f"p50 cold-solve latency, general-graph MCMF megakernel vs "
            f"scan backends, {tasks} tasks x {machines} machines "
            f"({problem.num_nodes} nodes, {len(problem.src)} arcs), "
            f"backend=mega/{platform}"
        ),
        "value": value,
        "unit": "ms",
        "detail": detail,
    }


def main(argv=None, log=print, err=functools.partial(print, file=sys.stderr)) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.mega_bench")
    ap.add_argument("--tasks", type=int, default=10_000)
    ap.add_argument("--machines", type=int, default=1_000)
    ap.add_argument("--solves", type=int, default=8)
    ap.add_argument("--max-supersteps", type=int, default=4096)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backends", default="mega,csr,ell",
                    help="comma-separated subset of mega,csr,ell")
    args = ap.parse_args(argv)
    out = run_bench(tasks=args.tasks, machines=args.machines, solves=args.solves,
                    max_supersteps=args.max_supersteps,
                    backends=tuple(args.backends.split(",")), device=args.device,
                    log=err)
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
