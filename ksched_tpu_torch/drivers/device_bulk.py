"""Device-resident scenarios: BASELINE.json's configs on DeviceBulkCluster.

Three clusters, each with the JAX package's bench constructor arguments
(bench.py `_device_bench` and `run_config`):

- ``10kx1k``: 10k tasks on 1k machines x 4 PUs x 4 slots, 10 jobs, the
  trivial cost model — one task class, so every solve is the closed
  form (no kernel);
- ``coco50k``: 50k tasks on 1k machines x 4 PUs x 16 slots, 20 jobs,
  the CoCo interference model over 4 task classes with per-machine
  penalties default_rng(7).integers(0, 40, (1000, 4)), preemption off —
  the iterative solves run kernel B1; steady decode window 1024;
- ``coco50k-preempt``: coco50k with preemption on (continuation
  discount 8) and a full tiered re-solve every round — kernel B2;
  steady mover-decode window 4096.

The scenario: a fill round that admits every task (jobs and classes
drawn from np.random.default_rng(seed)) and schedules them, then
host-driven rounds — complete 1% of the placed rows (picked by the same
generator from `fetch_state()`), admit 1% new tasks, `round()`. The
functions taking a cluster use only its public API, so the same
sequence can drive another implementation of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..costmodels import coco
from ..costmodels.device_costs import coco_device_cost_fn
from ..scheduler.device_bulk import DeviceBulkCluster

#: name -> (tasks, DeviceBulkCluster arguments; "cost": "coco" selects
#: the CoCo cost function with the bench's penalties)
CONFIGS = {
    "10kx1k": (10_000, dict(
        num_machines=1_000, pus_per_machine=4, slots_per_pu=4, num_jobs=10,
    )),
    "coco50k": (50_000, dict(
        num_machines=1_000, pus_per_machine=4, slots_per_pu=16, num_jobs=20,
        num_task_classes=4, cost="coco", unsched_cost=coco.UNSCHEDULED_COST,
        ec_cost=0, supersteps=1 << 17, decode_width=1024,
    )),
    "coco50k-preempt": (50_000, dict(
        num_machines=1_000, pus_per_machine=4, slots_per_pu=16, num_jobs=20,
        num_task_classes=4, cost="coco", unsched_cost=coco.UNSCHEDULED_COST,
        ec_cost=0, supersteps=1 << 17, preemption=True,
        continuation_discount=8, decode_width=4096,
    )),
}

#: share of the placed tasks completed, and of the pool admitted, per
#: host-driven round (the bench's churn)
CHURN = 0.01


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def coco_penalties(num_machines: int) -> np.ndarray:
    """The bench's per-machine CoCo penalties."""
    return np.random.default_rng(7).integers(0, 40, (num_machines, 4)).astype(np.int64)


def cluster_args(config: str) -> tuple:
    """(tasks, constructor arguments without the cost function, and the
    CoCo penalties or None) for a named config."""
    tasks, kw = CONFIGS[config]
    kw = dict(kw, task_capacity=next_pow2(tasks + 4096))
    penalties = coco_penalties(kw["num_machines"]) if kw.pop("cost", None) else None
    return tasks, kw, penalties


def device_cluster(config: str, device="cuda") -> tuple:
    """(DeviceBulkCluster for a named config on `device`, its task
    count)."""
    tasks, kw, penalties = cluster_args(config)
    cost_fn = None if penalties is None else coco_device_cost_fn(penalties)
    return DeviceBulkCluster(class_cost_fn=cost_fn, device=device, **kw), tasks


def fill(cluster, rng, tasks: int):
    """Admit `tasks` tasks with random jobs and classes, and schedule
    them in one round; returns the round's (un-fetched) stats."""
    cluster.add_tasks(
        tasks,
        rng.integers(0, cluster.J, tasks).astype(np.int32),
        rng.integers(0, cluster.C, tasks).astype(np.int32),
    )
    return cluster.round()


def host_round(cluster, rng, arrivals: int):
    """One host-driven round: complete 1% of the placed rows, admit
    `arrivals` tasks with random jobs and classes, schedule; returns the
    round's (un-fetched) stats."""
    st = cluster.fetch_state()
    placed = np.flatnonzero(np.asarray(st["live"]) & (np.asarray(st["pu"]) >= 0))
    rows = rng.choice(placed, size=int(len(placed) * CHURN), replace=False)
    cluster.complete_tasks(np.sort(rows).astype(np.int32))
    cluster.add_tasks(
        arrivals,
        rng.integers(0, cluster.J, arrivals).astype(np.int32),
        rng.integers(0, cluster.C, arrivals).astype(np.int32),
    )
    return cluster.round()


def run_rounds(cluster, tasks: int, rounds: int, seed: int = 0):
    """The scenario on a built cluster: yields (round index, stats)
    after the fill (round 0) and each of `rounds` host-driven rounds."""
    rng = np.random.default_rng(seed)
    yield 0, fill(cluster, rng, tasks)
    for r in range(1, rounds + 1):
        yield r, host_round(cluster, rng, max(1, int(tasks * CHURN)))


def device_bulk_rounds(config: str, rounds: int, device="cuda", seed: int = 0):
    """The scenario for a named config on `device`: yields (round index,
    cluster, stats) after the fill and each host-driven round."""
    cluster, tasks = device_cluster(config, device)
    for r, stats in run_rounds(cluster, tasks, rounds, seed):
        yield r, cluster, stats


def steady_rounds(cluster, tasks: int, num_rounds: int,
                  generator: torch.Generator):
    """`num_rounds` chained churn rounds on the device at the bench's
    churn (completion probability 1%, 1% of `tasks` arriving per round),
    draws from `generator`; returns the stacked (un-fetched) stats."""
    arrivals = max(1, int(tasks * CHURN))
    return cluster.run_steady_rounds(num_rounds, CHURN, arrivals,
                                     generator=generator)
