"""Device-resident scenarios: BASELINE.json's configs on DeviceBulkCluster.

Five clusters, each with the JAX package's bench constructor arguments
(bench.py `_device_bench` and `run_config`):

- ``10kx1k``: 10k tasks on 1k machines x 4 PUs x 4 slots, 10 jobs, the
  trivial cost model — one task class, so every solve is the closed
  form (no kernel);
- ``coco50k``: 50k tasks on 1k machines x 4 PUs x 16 slots, 20 jobs,
  the CoCo interference model over 4 task classes with per-machine
  penalties default_rng(7).integers(0, 40, (1000, 4)), preemption off —
  the iterative solves run kernel B1; steady decode window 1024;
- ``coco50k-preempt``: coco50k with preemption on (continuation
  discount 8) under bench.py's three-tier scheme (bench.py:1639-1705):
  steady rounds are incremental (residents pinned, kernel B1, 4096-row
  backlog window, 8192 supersteps before escalating to the scoped
  tier), a scoped tiered re-solve (B2) fires every 16 rounds or on a
  census drift of 10,000 over the machines that drifted by 16, with a
  16,384-row mover window, and a global one every 128 rounds;
- ``coco50k-preempt-full``: coco50k with preemption on and a full
  tiered re-solve every round — kernel B2; steady mover-decode window
  4096;
- ``quincy10k``: 10k tasks on 1k machines x 4 PUs x 4 slots, 10 jobs,
  Quincy data locality in group mode (bench.py:1575-1613): 480 blocks
  of 512 MB on 3 machines each, every task reading one, grouped by
  signature into 512 groups (costmodels/quincy_device.py, 64 MB cost
  units) — kernel B1 on the two-stage and compacted grouped solves;
  steady decode window 2048.

The scenario: a fill round that admits every task (jobs and classes
drawn from np.random.default_rng(seed), after the group setup's draws
in group mode, as `_device_bench` draws them) and schedules them, then
host-driven rounds — complete 1% of the placed rows (picked by the same
generator from `fetch_state()`), admit 1% new tasks (in group mode
each in a group drawn uniformly from all G), `round()`. The functions
taking a cluster use only its public API, so the same sequence can
drive another implementation of it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..costmodels import coco
from ..costmodels.device_costs import coco_device_cost_fn
from ..costmodels.quincy import MB
from ..costmodels.quincy_device import QuincyGroupTable
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
        continuation_discount=8, preempt_every=16, preempt_drift=10_000,
        preempt_global_every=128, preempt_scope_tau=16,
        preempt_incr_budget=8192, preempt_scoped_width=16_384,
        decode_width=4096,
    )),
    "coco50k-preempt-full": (50_000, dict(
        num_machines=1_000, pus_per_machine=4, slots_per_pu=16, num_jobs=20,
        num_task_classes=4, cost="coco", unsched_cost=coco.UNSCHEDULED_COST,
        ec_cost=0, supersteps=1 << 17, preemption=True,
        continuation_discount=8, decode_width=4096,
    )),
    "quincy10k": (10_000, dict(
        num_machines=1_000, pus_per_machine=4, slots_per_pu=4, num_jobs=10,
        num_groups=512, groups="quincy", supersteps=1 << 17,
        decode_width=2048,
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


def quincy_setup(cluster, rng, blocks: int = 480):
    """bench.py's quincy10k group setup (bench.py:1579-1598): `blocks`
    blocks of 512 MB, each on 3 machines drawn from `rng`, then one
    block per task drawn from `rng`; the tasks' groups come from a
    QuincyGroupTable at 64 MB cost units, pushed to the cluster. Returns
    the groups of quincy10k's fill tasks."""
    table = QuincyGroupTable(num_groups=cluster.G, num_machines=cluster.M,
                             cost_unit_mb=64)
    for b in range(1, blocks + 1):
        table.blocks.register(
            b, 512 * MB, rng.choice(cluster.M, size=3, replace=False).tolist())
    tasks = CONFIGS["quincy10k"][0]
    task_blocks = rng.integers(1, blocks + 1, tasks)
    groups = table.groups_for(np.zeros(tasks, np.int32),
                              [[int(b)] for b in task_blocks])
    table.sync(cluster)
    return groups


def cluster_args(config: str) -> tuple:
    """(tasks, constructor arguments without the cost function, and the
    CoCo penalties or None) for a named config."""
    tasks, kw = CONFIGS[config]
    kw = dict(kw, task_capacity=next_pow2(tasks + 4096))
    kw.pop("groups", None)
    penalties = coco_penalties(kw["num_machines"]) if kw.pop("cost", None) else None
    return tasks, kw, penalties


def group_setup(config: str):
    """The config's group setup (cluster, rng) -> the fill's groups, or
    None."""
    return quincy_setup if CONFIGS[config][1].get("groups") == "quincy" else None


def device_cluster(config: str, device="cuda") -> tuple:
    """(DeviceBulkCluster for a named config on `device`, its task
    count)."""
    tasks, kw, penalties = cluster_args(config)
    cost_fn = None if penalties is None else coco_device_cost_fn(penalties)
    return DeviceBulkCluster(class_cost_fn=cost_fn, device=device, **kw), tasks


def fill(cluster, rng, tasks: int, setup=None):
    """Admit `tasks` tasks with random jobs and classes (and the groups
    `setup(cluster, rng)` returns, drawn first), and schedule them in
    one round; returns the round's (un-fetched) stats."""
    groups = None if setup is None else setup(cluster, rng)
    cluster.add_tasks(
        tasks,
        rng.integers(0, cluster.J, tasks).astype(np.int32),
        rng.integers(0, cluster.C, tasks).astype(np.int32),
        groups=groups,
    )
    return cluster.round()


def host_round(cluster, rng, arrivals: int):
    """One host-driven round: complete 1% of the placed rows, admit
    `arrivals` tasks with random jobs and classes (in group mode, groups
    drawn uniformly from all G after them), schedule; returns the
    round's (un-fetched) stats."""
    st = cluster.fetch_state()
    placed = np.flatnonzero(np.asarray(st["live"]) & (np.asarray(st["pu"]) >= 0))
    rows = rng.choice(placed, size=int(len(placed) * CHURN), replace=False)
    cluster.complete_tasks(np.sort(rows).astype(np.int32))
    jobs = rng.integers(0, cluster.J, arrivals).astype(np.int32)
    classes = rng.integers(0, cluster.C, arrivals).astype(np.int32)
    groups = (rng.integers(0, cluster.G, arrivals).astype(np.int32)
              if cluster.grouped else None)
    cluster.add_tasks(arrivals, jobs, None if groups is not None else classes,
                      groups=groups)
    return cluster.round()


def run_rounds(cluster, tasks: int, rounds: int, seed: int = 0, setup=None):
    """The scenario on a built cluster: yields (round index, stats)
    after the fill (round 0, with the group setup `setup`) and each of
    `rounds` host-driven rounds."""
    rng = np.random.default_rng(seed)
    yield 0, fill(cluster, rng, tasks, setup)
    for r in range(1, rounds + 1):
        yield r, host_round(cluster, rng, max(1, int(tasks * CHURN)))


def device_bulk_rounds(config: str, rounds: int, device="cuda", seed: int = 0):
    """The scenario for a named config on `device`: yields (round index,
    cluster, stats) after the fill and each host-driven round."""
    cluster, tasks = device_cluster(config, device)
    for r, stats in run_rounds(cluster, tasks, rounds, seed, group_setup(config)):
        yield r, cluster, stats


def steady_rounds(cluster, tasks: int, num_rounds: int,
                  generator: torch.Generator):
    """`num_rounds` chained churn rounds on the device at the bench's
    churn (completion probability 1%, 1% of `tasks` arriving per round),
    draws from `generator`; returns the stacked (un-fetched) stats."""
    arrivals = max(1, int(tasks * CHURN))
    return cluster.run_steady_rounds(num_rounds, CHURN, arrivals,
                                     generator=generator)
