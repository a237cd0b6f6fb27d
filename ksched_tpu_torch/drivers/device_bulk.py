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
  steady decode window 2048;
- ``ref100``: the reference's fakeMachines smoke (bench.py:1564-1568,
  cmd/k8sscheduler/scheduler.go:191-202): 100 tasks on 10 machines x 1
  PU x 16 slots, 3 jobs, one class — the closed form (no kernel); 5%
  churn;
- ``whare-hetero``: 20k tasks on 1k machines x 4 PUs x 8 slots, 20 jobs,
  Whare-Map over 4 classes with per-machine platform factors
  default_rng(7).integers(80, 140, 1000) (bench.py:1708-1725,
  whare_device_cost_fn at 32 slots a machine) — kernel B1; steady decode
  window 2048.

The scenario: a fill round that admits every task (jobs and classes
drawn from np.random.default_rng(seed), after the group setup's draws
in group mode, as `_device_bench` draws them) and schedules them, then
host-driven rounds — complete 1% of the placed rows (picked by the same
generator from `fetch_state()`), admit 1% new tasks (5% of each for
ref100, the config's churn; in group mode
each in a group drawn uniformly from all G), `round()`. The functions
taking a cluster use only its public API, so the same sequence can
drive another implementation of it.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..costmodels import coco, device_costs, whare
from ..costmodels.quincy import MB
from ..costmodels.quincy_device import QuincyGroupTable
from ..scheduler.device_bulk import DeviceBulkCluster

#: name -> (tasks, DeviceBulkCluster arguments; "cost" selects the CoCo
#: or Whare-Map cost function with the bench's penalties or platform
#: factors, "churn" a churn other than CHURN)
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
    "ref100": (100, dict(
        num_machines=10, pus_per_machine=1, slots_per_pu=16, num_jobs=3,
        churn=0.05,
    )),
    "whare-hetero": (20_000, dict(
        num_machines=1_000, pus_per_machine=4, slots_per_pu=8, num_jobs=20,
        num_task_classes=4, cost="whare", unsched_cost=whare.UNSCHEDULED_COST,
        ec_cost=0, supersteps=1 << 17, decode_width=2048,
    )),
}

#: share of the placed tasks completed, and of the pool admitted, per
#: host-driven round (the bench's churn)
CHURN = 0.01


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def coco_penalties(num_machines: int) -> np.ndarray:
    """The bench's per-machine CoCo penalties."""
    return np.random.default_rng(7).integers(0, 40, (num_machines, 4)).astype(np.int64)  # kschedlint: host-only (host numpy)


def whare_platform_factors(num_machines: int) -> np.ndarray:
    """The bench's per-machine Whare-Map platform factors: run_config's
    first draw of default_rng(7) (bench.py:1711)."""
    return np.random.default_rng(7).integers(80, 140, num_machines).astype(np.int64)  # kschedlint: host-only (host numpy)


def churn_of(config: str) -> float:
    """The config's churn: the share of the placed tasks completed, and
    of the pool admitted, per round."""
    return CONFIGS[config][1].get("churn", CHURN)


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
    cost function's spec: None, or (name, arguments) of
    costmodels/device_costs.py's `<name>_device_cost_fn`) for a named
    config."""
    tasks, kw = CONFIGS[config]
    kw = dict(kw, task_capacity=next_pow2(tasks + 4096))
    kw.pop("groups", None)
    kw.pop("churn", None)
    cost = kw.pop("cost", None)
    M = kw["num_machines"]
    if cost == "coco":
        cost = ("coco", dict(penalties=coco_penalties(M)))
    elif cost == "whare":
        slots = kw["pus_per_machine"] * kw["slots_per_pu"]
        cost = ("whare", dict(slots_per_machine=slots,
                              platform_factor=whare_platform_factors(M)))
    return tasks, kw, cost


def cost_fn(cost, module=device_costs):
    """The class cost function of a cost spec (cluster_args), made by
    `module` (this package's costmodels/device_costs.py by default)."""
    if cost is None:
        return None
    name, args = cost
    return getattr(module, f"{name}_device_cost_fn")(**args)


def group_setup(config: str):
    """The config's group setup (cluster, rng) -> the fill's groups, or
    None."""
    return quincy_setup if CONFIGS[config][1].get("groups") == "quincy" else None


def device_cluster(config: str, device="cuda") -> tuple:
    """(DeviceBulkCluster for a named config on `device`, its task
    count)."""
    tasks, kw, cost = cluster_args(config)
    return DeviceBulkCluster(class_cost_fn=cost_fn(cost), device=device, **kw), tasks


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


def host_round(cluster, rng, arrivals: int, churn: float = CHURN):
    """One host-driven round: complete `churn` of the placed rows, admit
    `arrivals` tasks with random jobs and classes (in group mode, groups
    drawn uniformly from all G after them), schedule; returns the
    round's (un-fetched) stats."""
    st = cluster.fetch_state()
    placed = np.flatnonzero(np.asarray(st["live"]) & (np.asarray(st["pu"]) >= 0))
    rows = rng.choice(placed, size=int(len(placed) * churn), replace=False)
    cluster.complete_tasks(np.sort(rows).astype(np.int32))
    jobs = rng.integers(0, cluster.J, arrivals).astype(np.int32)
    classes = rng.integers(0, cluster.C, arrivals).astype(np.int32)
    groups = (rng.integers(0, cluster.G, arrivals).astype(np.int32)
              if cluster.grouped else None)
    cluster.add_tasks(arrivals, jobs, None if groups is not None else classes,
                      groups=groups)
    return cluster.round()


def run_rounds(cluster, tasks: int, rounds: int, seed: int = 0, setup=None,
               churn: float = CHURN):
    """The scenario on a built cluster: yields (round index, stats)
    after the fill (round 0, with the group setup `setup`) and each of
    `rounds` host-driven rounds at `churn`."""
    rng = np.random.default_rng(seed)
    yield 0, fill(cluster, rng, tasks, setup)
    for r in range(1, rounds + 1):
        yield r, host_round(cluster, rng, max(1, int(tasks * churn)), churn)


def device_bulk_rounds(config: str, rounds: int, device="cuda", seed: int = 0):
    """The scenario for a named config on `device`: yields (round index,
    cluster, stats) after the fill and each host-driven round."""
    cluster, tasks = device_cluster(config, device)
    for r, stats in run_rounds(cluster, tasks, rounds, seed, group_setup(config),
                               churn_of(config)):
        yield r, cluster, stats


def steady_rounds(cluster, tasks: int, num_rounds: int,
                  generator: torch.Generator):
    """`num_rounds` chained churn rounds on the device at the bench's
    churn (completion probability 1%, 1% of `tasks` arriving per round),
    draws from `generator`; returns the stacked (un-fetched) stats."""
    arrivals = max(1, int(tasks * CHURN))
    return cluster.run_steady_rounds(num_rounds, CHURN, arrivals,
                                     generator=generator)


def stats_sha256(stats: dict) -> str:
    """sha256 of fetched per-round stats stacked as int32 in key order."""
    return hashlib.sha256(np.ascontiguousarray(np.stack(
        [np.asarray(stats[k]).astype(np.int32) for k in sorted(stats)])).tobytes()
    ).hexdigest()
