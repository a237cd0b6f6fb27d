"""The seeded scenarios of the multi-device rung's checks: a host
BulkCluster with C class cost rows for the sharded layered transport,
and the what-if batches scored against it.

Both packages run these alike: `layered_cluster` takes the BulkCluster
class and the backend as arguments and draws everything else from one
numpy seed, so the JAX package's BulkCluster and this package's hold
the same tasks, classes and costs.
"""

from __future__ import annotations

import numpy as np

#: the smoke's size: 1,000 machines (Mp = 1,024), 4 class cost rows,
#: 10,000 tasks on 16,000 slots
LAYERED = dict(machines=1_000, classes=4, tasks=10_000, pus=4, slots=4,
               jobs=8, seed=5, unsched_cost=25)
#: the what-if batches: K drain candidates and K surge rows
WHATIF = dict(drains=16, surges=8, seed=11)
#: the tiered check of the sharded layered transport: [4, 1,024]
TIERED = dict(C=4, M=1_000, Mp=1_024, seed=3, refine_waves=8)


def layered_cluster(BulkCluster, backend, machines: int, classes: int,
                    tasks: int, pus: int, slots: int, jobs: int, seed: int,
                    unsched_cost: int):
    """A BulkCluster (of the package whose class is passed) with
    `classes` seeded cost rows over `machines` machines and `tasks`
    tasks added, not yet scheduled."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 10, (classes, machines)).astype(np.int32)
    cluster = BulkCluster(
        num_machines=machines,
        pus_per_machine=pus,
        slots_per_pu=slots,
        num_jobs=jobs,
        backend=backend,
        task_capacity=tasks,
        num_task_classes=classes,
        class_cost_fn=lambda cl: cost,
        unsched_cost=unsched_cost,
    )
    cluster.add_tasks(tasks, rng.integers(0, jobs, tasks).astype(np.int32),
                      rng.integers(0, classes, tasks).astype(np.int32))
    return cluster


def whatif_inputs(cluster, drains: int, surges: int, seed: int):
    """(drain machine indices [drains], surge rows [surges, C]): seeded
    distinct machines, and per-class arrivals from none to several
    times the cluster's free capacity."""
    rng = np.random.default_rng(seed)
    machines = np.sort(rng.choice(cluster.M, size=drains, replace=False))
    scale = np.array([0] + [4 ** i for i in range(surges - 1)], np.int64)
    surge = rng.integers(1, 5, (surges, cluster.C)).astype(np.int64) * scale[:, None]
    return machines.astype(np.int64), surge


def round_record(cluster, result) -> dict:
    """A scheduling round's result as comparable values: the sha256 of
    the placements (task rows, PU rows) and the unscheduled count."""
    import hashlib

    placed = np.stack([np.asarray(result.placed_tasks, np.int64),
                       np.asarray(result.placed_pus, np.int64)])
    return {
        "placements_sha256": hashlib.sha256(placed.tobytes()).hexdigest(),
        "num_placed": int(placed.shape[1]),
        "num_unscheduled": int(result.num_unscheduled),
    }


def tiered_instance(C: int, M: int, Mp: int, seed: int, refine_waves: int = 0):
    """(wLo, wHi, R, supply, col_cap, eps0) of a seeded tiered transport
    instance, numpy int32, costs scaled by pad_geometry's n_scale, eps0
    the full range (`refine_waves` names the solve's setting and does
    not enter the data)."""
    from ..solver.layered import pad_geometry

    del refine_waves
    rng = np.random.default_rng(seed)
    _mp, n_scale = pad_geometry(M, C)
    w = np.zeros((C, Mp), np.int64)
    w[:, :M] = rng.integers(-30, 5, (C, M))
    disc = rng.integers(0, 4, (C, Mp))
    supply = rng.integers(100, 600, C).astype(np.int32)
    cap = np.zeros(Mp, np.int32)
    cap[:M] = rng.integers(0, 3, M)
    cap[-1] = supply.sum()
    R = rng.integers(0, 2, (C, Mp)).astype(np.int32)
    wHi = (w * n_scale).astype(np.int32)
    wLo = ((w - disc) * n_scale).astype(np.int32)
    eps0 = int(max(1, np.abs(wHi).max()))
    return wLo, wHi, R, supply, cap, eps0
