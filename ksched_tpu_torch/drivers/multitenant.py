"""Drive the multi-tenant service: bench.py's `multitenant` config and a
fleet of full-size cells.

`run_multitenant_bench` is bench.py's `_multitenant_bench`: N cells of
mixed sizes (three classes, three pow2 shape buckets) driven through two
arms in turns, each round every cell completing a share of its tasks
and adding as many: `batched`, in which every cell parks its lane and
one stacked solve per (bucket, policy) group serves them
(tenancy/batch.py), and `sequential`, each cell solved alone by its own
scan-CSR solver. The cells' placements must be equal across the arms
every round. `run_tenant_fleet` serves `FleetConfig.tenants` cells of
BASELINE's round (10k pods on 1,000 machines x 4 PUs x 4 slots each,
then rounds of 1% completions and 100 arrivals) through one
MultiTenantService.

Both take the package as a namespace of its classes (`package()` builds
this one's), as drivers/service.py's `run_service` does, so the same
code drives the JAX package in the reference script
(tests/torch_tenancy_reference.py) and this one on the card. Each
returns per-round records (placements' sha256, supersteps, the stacked
solves' groups) and host-clock times taken after `pkg.sync()`.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..utils.device import resolve_device
from .service import _complete_share, live_placements, placements_sha256

#: (machines, tasks) per cell class -> 3 pow2 shape buckets
SIZES = ((12, 96), (24, 192), (48, 384))


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def _pctl(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else 0.0


class _Cell:
    """One bench cell: its cluster, its own id stream (swapped in around
    every phase that draws ids) and its churn draws."""

    def __init__(self, pkg, idx: int, backend):
        machines, tasks = SIZES[idx % len(SIZES)]
        self.pkg, self.idx, self.backend = pkg, idx, backend
        # the same seed's continuation in both arms
        pkg.seed_rng(10_000 + idx)
        self.sched, self.rmap, self.jmap, self.tmap, self.root = pkg.build_cluster(
            num_machines=machines, num_cores=1, pus_per_core=4, max_tasks_per_pu=4,
            backend=backend)
        self.job_id = pkg.add_job(self.sched, self.jmap, self.tmap, num_tasks=tasks)
        self.sched.schedule_all_jobs()  # fill solve (not measured)
        self.rng = np.random.default_rng(500 + idx)
        self.k = max(1, tasks // 50)
        self._rng_state = pkg.rng().getstate()

    def swap_in(self) -> None:
        self._outer = self.pkg.rng().getstate()
        self.pkg.rng().setstate(self._rng_state)

    def park(self) -> None:
        self._rng_state = self.pkg.rng().getstate()
        self.pkg.rng().setstate(self._outer)

    def churn(self) -> None:
        bound = sorted(self.sched.task_bindings.items())
        idx = sorted(int(x) for x in self.rng.choice(len(bound), self.k, replace=False))
        for i in reversed(idx):
            self.sched.handle_task_completion(self.tmap.find(bound[i][0]))
        for _ in range(self.k):
            self.pkg.add_task_to_job(self.job_id, self.jmap, self.tmap)
        self.sched.add_job(self.jmap.find(self.job_id))

    def placements(self) -> Dict[str, int]:
        return {self.tmap.find(t).name: rid for t, rid in self.sched.task_bindings.items()}


def run_multitenant_bench(pkg, cells: int = 16, rounds: int = 24, warmup: int = 4,
                          restart_budget: int = 64) -> dict:
    """bench.py's `_multitenant_bench` through package `pkg` (its
    build_cluster, add_job, add_task_to_job, seed_rng, rng, StackedBatcher,
    LaneSolver and `sequential(restart_budget)` solver factories, and a
    `sync()` that waits for the device). Raises AssertionError when a
    cell's placements differ between the arms.

    Returns {"rounds": per round (warm-up included) each arm's fleet ms,
    summed lane supersteps and the sha256 of every cell's placements,
    and the batched arm's stacked groups, each group's supersteps and
    the flush's host reads (None where the package does not count
    them); "arms": per arm the fleet p50/p99/mean ms and supersteps p50
    over the measured rounds and each cell's p50/p99 ms}."""
    batcher = pkg.StackedBatcher()
    arms = {
        "batched": [_Cell(pkg, i, pkg.LaneSolver(batcher, tenant=f"c{i}",
                                                   restart_budget=restart_budget))
                    for i in range(cells)],
        "sequential": [_Cell(pkg, i, pkg.sequential(restart_budget)) for i in range(cells)],
    }
    fleet_ms = {a: [] for a in arms}
    cell_ms = {a: [[] for _ in range(cells)] for a in arms}
    ss = {a: [] for a in arms}
    records = []
    for r in range(warmup + rounds):
        rec = {}
        for label, fleet in arms.items():
            pkg.sync()
            t0 = time.perf_counter()
            if label == "batched":
                tokens = []
                for cell in fleet:
                    tc = time.perf_counter()
                    cell.swap_in()
                    cell.churn()
                    tokens.append(cell.sched.schedule_all_jobs_async())
                    cell.park()
                    cell_ms[label][cell.idx].append((time.perf_counter() - tc) * 1e3)
                groups = batcher.flush()
                for cell, token in zip(fleet, tokens):
                    tc = time.perf_counter()
                    if token is not None:
                        cell.sched.finish_scheduling()
                    cell_ms[label][cell.idx][-1] += (time.perf_counter() - tc) * 1e3
            else:
                for cell in fleet:
                    tc = time.perf_counter()
                    cell.swap_in()
                    cell.churn()
                    cell.sched.schedule_all_jobs()
                    cell.park()
                    cell_ms[label][cell.idx].append((time.perf_counter() - tc) * 1e3)
            pkg.sync()
            wall = (time.perf_counter() - t0) * 1e3
            work = sum(c.backend.last_supersteps for c in fleet)
            rec[label] = {"fleet_ms": wall, "supersteps": work,
                          "sha256": _sha([c.placements() for c in fleet])}
            if label == "batched":
                rec[label].update(groups=groups,
                                  stack_supersteps=getattr(batcher, "last_supersteps", None),
                                  stack_reads=getattr(batcher, "last_reads", None))
            if r >= warmup:
                fleet_ms[label].append(wall)
                ss[label].append(work)
            else:
                for cell in fleet:
                    cell_ms[label][cell.idx].pop()
        for i in range(cells):
            assert arms["batched"][i].placements() == arms["sequential"][i].placements(), (
                f"round {r}: cell {i} placements diverged between the batched and "
                "sequential arms")
        records.append(rec)
    stats = {
        label: {
            "fleet_p50_ms": _pctl(fleet_ms[label], 50),
            "fleet_p99_ms": _pctl(fleet_ms[label], 99),
            "fleet_mean_ms": float(np.mean(fleet_ms[label])) if fleet_ms[label] else 0.0,
            "supersteps_per_round_p50": _pctl(ss[label], 50),
            "per_tenant": {f"cell_{i}": {"p50_ms": _pctl(v, 50), "p99_ms": _pctl(v, 99)}
                           for i, v in enumerate(cell_ms[label]) if v},
        }
        for label in arms
    }
    return {"rounds": records, "arms": stats}


@dataclass(frozen=True)
class FleetConfig:
    """`tenants` cells of `machines` x 1 core x `pus_per_core` PUs x
    `slots` slots, `pods` pods each in the first round, then `rounds`
    rounds of `churn` completions and `arrivals` pods per cell; cell i
    is seeded 1000 + i (cli.py's --tenants) and its workload draws from
    [seed, i]."""

    tenants: int = 4
    machines: int = 1000
    pus_per_core: int = 4
    slots: int = 4
    pods: int = 10_000
    rounds: int = 4
    churn: float = 0.01
    arrivals: int = 100
    seed: int = 1
    pipeline: bool = True


def run_tenant_fleet(pkg, cfg: FleetConfig) -> dict:
    """`cfg` through package `pkg`'s MultiTenantService (and its
    SyntheticClusterAPI, PodEvent, Registry and `sync()`).

    Returns {"rounds": per round its wall ms and, per tenant, the pods
    bound, the live placements' count and sha256, the lane's supersteps
    and warm scope and the round's ladder rung; with the flush's stacked
    groups, each group's supersteps and host reads (None where the
    package does not count them)}, and "service": the service."""
    mts = pkg.MultiTenantService(registry=pkg.Registry(), pipeline=cfg.pipeline)
    rngs, seq = {}, {}
    for i in range(cfg.tenants):
        tid = f"cell{i}"
        api = pkg.SyntheticClusterAPI(
            pod_chan_size=cfg.pods + cfg.rounds * cfg.arrivals + 1)
        mts.add_tenant(tid, api=api, machines=cfg.machines,
                       pus_per_core=cfg.pus_per_core, slots=cfg.slots, seed=1000 + i)
        rngs[tid] = np.random.default_rng([cfg.seed, i])
        for j in range(cfg.pods):
            api.submit_pod(pkg.PodEvent(pod_id=f"{tid}_pod_{j}"))
        seq[tid] = cfg.pods
    out = {"rounds": [], "service": mts}
    for r in range(cfg.rounds + 1):
        if r:
            for tid, cell in mts.cells.items():
                _complete_share(cell.svc, rngs[tid], cfg.churn)
                for j in range(seq[tid], seq[tid] + cfg.arrivals):
                    cell.api.submit_pod(pkg.PodEvent(pod_id=f"{tid}_pod_{j}"))
                seq[tid] += cfg.arrivals
        pkg.sync()
        t0 = time.perf_counter()
        bound = mts.run_round(now=float(r))
        pkg.sync()
        wall = (time.perf_counter() - t0) * 1e3
        row = {"wall_ms": wall, "groups": mts.batcher.last_groups,
               "stack_supersteps": getattr(mts.batcher, "last_supersteps", None),
               "stack_reads": getattr(mts.batcher, "last_reads", None), "tenants": {}}
        for tid, cell in sorted(mts.cells.items()):
            placements = live_placements(cell.svc)
            last = cell.svc.tracer.records[-1]
            row["tenants"][tid] = {
                "bound": int(bound.get(tid, 0)), "placed": len(placements),
                "sha256": placements_sha256(placements),
                "supersteps": int(cell.lane.last_supersteps),
                "scope": cell.lane.last_warm_scope, "rung": int(last.solver_rung),
                "noop": bool(last.noop_round)}
        out["rounds"].append(row)
    mts.drain()
    return out


def package(device="cuda"):
    """This package as the drivers here and drivers/soak.py's
    `run_tenant_soak` take it, its solves on `device`."""
    from types import SimpleNamespace

    import torch

    from ..cluster import PodEvent, SyntheticClusterAPI
    from ..obs.metrics import Registry
    from ..runtime.chaos import ChaosPolicy, FaultInjector
    from ..solver.csr_solver import CsrSolver
    from ..tenancy import LaneSolver, MultiTenantService, StackedBatcher
    from ..utils import seed_rng
    from ..utils.ids import rng
    from .synthetic import add_job, add_task_to_job, build_cluster

    dev = resolve_device(device)
    return SimpleNamespace(
        build_cluster=build_cluster, add_job=add_job, add_task_to_job=add_task_to_job,
        seed_rng=seed_rng, rng=rng,
        StackedBatcher=lambda: StackedBatcher(device=dev),
        LaneSolver=lambda batcher, **kw: LaneSolver(batcher, device=dev, **kw),
        sequential=lambda budget: CsrSolver(restart_budget=budget, slot_stable=False,
                                            device=dev),
        MultiTenantService=lambda **kw: MultiTenantService(device=dev, **kw),
        SyntheticClusterAPI=SyntheticClusterAPI, PodEvent=PodEvent, Registry=Registry,
        ChaosPolicy=ChaosPolicy, FaultInjector=FaultInjector,
        sync=(torch.cuda.synchronize if dev.type == "cuda" else lambda: None))
