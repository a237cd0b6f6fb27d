"""The JAX package's values for chip_smoke.py's device-bulk phases.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_device_bulk_reference.py [config ...]

Runs each DeviceBulkCluster scenario of ksched_tpu_torch/drivers/
device_bulk.py — the fill, then host-driven rounds, through the same
driver functions, then for the configs of STEADY steady rounds on the
JAX package's own draws (`run_steady_rounds(seed=STEADY_SEED)` at the
bench's churn) — on the JAX package's DeviceBulkCluster with the same
constructor arguments (quincy10k's groups from the JAX package's own
QuincyGroupTable, as bench.py builds them), on the CPU, and prints one
JSON object per
config: per host-driven round the stats that chip_smoke.py checks and
the sha256 of the `pu` array (int32 bytes) after them; for the steady
rounds the count of rounds of each tier, the per-round stats that
chip_smoke.py checks, the sha256 of all the rounds' stats stacked as
int32 (`stats_sha256`) and the `pu` sha256 after them. These are
chip_smoke.py's REF_BULK constants. On the CPU: about 15 s for
coco50k-preempt-full, coco50k and 10kx1k together, 35 s for
coco50k-preempt with its 130 steady rounds, 31 s for quincy10k, 13 s
for whare-hetero and 8 s for ref100; up to 1.4 GB.
"""

import hashlib
import json
import sys

import numpy as np

from ksched_tpu.costmodels import device_costs
from ksched_tpu.costmodels.quincy import MB
from ksched_tpu.costmodels.quincy_device import QuincyGroupTable
from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster
from ksched_tpu_torch.drivers.device_bulk import (
    CONFIGS,
    churn_of,
    cluster_args,
    cost_fn,
    group_setup,
    run_rounds,
    stats_sha256,
)

#: config -> host-driven rounds after the fill, as chip_smoke.py runs them
ROUNDS = {"coco50k-preempt-full": 4, "coco50k": 2, "10kx1k": 2,
          "coco50k-preempt": 4, "quincy10k": 2, "whare-hetero": 2, "ref100": 2}
#: config -> steady rounds after the host-driven ones
STEADY = {"coco50k-preempt": 130, "quincy10k": 32, "whare-hetero": 32, "ref100": 64}
STEADY_SEED = 1
KEYS = ("placed", "migrated", "preempted", "unscheduled", "objective",
        "supersteps", "converged")
STEADY_KEYS = KEYS + ("census_drift", "active_groups")


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def tiers(stats: dict) -> dict:
    """Rounds of each tier of a hybrid run: global, scoped (fired, not
    global; escalated ones among them) and incremental."""
    full = np.asarray(stats["full_round"], bool)
    glob = np.asarray(stats["global_round"], bool)
    esc = np.asarray(stats["escalated_round"], bool)
    return {"global": int(glob.sum()), "scoped": int((full & ~glob).sum()),
            "escalated": int(esc.sum()), "incremental": int((~full).sum())}


def jax_quincy_setup(cluster, rng, blocks: int = 480):
    """quincy10k's group setup on the JAX package's own QuincyGroupTable,
    as bench.py:1581-1599 builds it and in the port's draw order (the
    block placement, then the tasks' blocks, from `rng`), so the port's
    table is held against the reference's and not against itself."""
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


def reference(config: str) -> dict:
    tasks, kw, cost = cluster_args(config)
    churn = churn_of(config)
    cluster = DeviceBulkCluster(class_cost_fn=cost_fn(cost, device_costs), **kw)
    out = {}
    setup = None if group_setup(config) is None else jax_quincy_setup
    for _r, stats in run_rounds(cluster, tasks, ROUNDS[config], setup=setup, churn=churn):
        got = cluster.fetch_stats(stats)
        for k in KEYS:
            if k in got:
                out.setdefault(k, []).append(int(got[k]))
    out["pu_sha256"] = sha256(np.asarray(cluster.fetch_state()["pu"], np.int32))
    if config in STEADY:
        got = cluster.fetch_stats(cluster.run_steady_rounds(
            STEADY[config], churn, max(1, int(tasks * churn)), seed=STEADY_SEED))
        steady = {k: np.asarray(got[k]).astype(np.int64).tolist()
                  for k in STEADY_KEYS if k in got}
        if cluster.hybrid_preempt:
            steady["tiers"] = tiers(got)
        steady["stats_sha256"] = stats_sha256(got)
        steady["pu_sha256"] = sha256(np.asarray(cluster.fetch_state()["pu"], np.int32))
        out["steady"] = steady
    return out


def main(argv) -> int:
    for config in argv or list(ROUNDS):
        print(json.dumps({config: reference(config)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
