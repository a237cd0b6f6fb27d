"""Cut configs of tools/tail_repro.py for the tool tests: the same
cluster in either package, built from the same seeds. Imports the JAX
package only when asked for its side, so card-only tests (run without
JAX) can use the port's side."""

from types import SimpleNamespace

import numpy as np

M = 40
TASKS = 600


def _pkg(side, device="cpu"):
    if side == "jax":
        from ksched_tpu.costmodels import coco, device_costs, whare
        from ksched_tpu.costmodels.quincy_device import QuincyGroupTable
        from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster

        return SimpleNamespace(Cluster=DeviceBulkCluster, costs=device_costs, coco=coco,
                               whare=whare, Table=QuincyGroupTable, kw={})
    from ksched_tpu_torch.costmodels import coco, device_costs, whare
    from ksched_tpu_torch.costmodels.quincy_device import QuincyGroupTable
    from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster

    return SimpleNamespace(Cluster=DeviceBulkCluster, costs=device_costs, coco=coco,
                           whare=whare, Table=QuincyGroupTable, kw={"device": device})


def small_config(side, name, device="cpu"):
    """tools/tail_repro.py's `name` config at M = 40 machines, 600
    tasks, in either package ("jax" or "torch", the latter on `device`):
    (cluster, tasks, initial groups or None)."""
    p = _pkg(side, device)
    rng = np.random.default_rng(7)
    if name == "whare":
        plat = rng.integers(80, 140, M).astype(np.int64)
        dev = p.Cluster(num_machines=M, pus_per_machine=4, slots_per_pu=8, num_jobs=20,
                        num_task_classes=4, task_capacity=1024,
                        class_cost_fn=p.costs.whare_device_cost_fn(
                            slots_per_machine=32, platform_factor=plat),
                        unsched_cost=p.whare.UNSCHEDULED_COST, ec_cost=0,
                        supersteps=1 << 17, decode_width=256, **p.kw)
        return dev, TASKS, None
    if name == "coco-preempt":
        pen = rng.integers(0, 40, (M, 4)).astype(np.int64)
        dev = p.Cluster(num_machines=M, pus_per_machine=4, slots_per_pu=8, num_jobs=20,
                        num_task_classes=4, task_capacity=1024,
                        class_cost_fn=p.costs.coco_device_cost_fn(pen),
                        unsched_cost=p.coco.UNSCHEDULED_COST, ec_cost=0,
                        supersteps=1 << 17, preemption=True, continuation_discount=8,
                        **p.kw)
        return dev, TASKS, None
    assert name == "quincy"
    G, n_blocks, tasks = 32, 24, 400
    dev = p.Cluster(num_machines=M, pus_per_machine=4, slots_per_pu=4, num_jobs=10,
                    task_capacity=1024, num_groups=G, supersteps=1 << 17,
                    decode_width=256, **p.kw)
    table = p.Table(num_groups=G, num_machines=M, cost_unit_mb=64)
    for b in range(1, n_blocks + 1):
        table.blocks.register(b, 512 << 20, rng.choice(M, size=3, replace=False).tolist())
    blocks = rng.integers(1, n_blocks + 1, tasks)
    groups = table.groups_for(np.zeros(tasks, np.int32), [[int(b)] for b in blocks])
    table.sync(dev)
    return dev, tasks, groups
