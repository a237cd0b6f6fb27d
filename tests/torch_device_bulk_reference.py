"""The JAX package's values for chip_smoke.py's device-bulk phase.

    JAX_PLATFORMS=cpu python tests/torch_device_bulk_reference.py [config ...]

Runs each DeviceBulkCluster scenario of ksched_tpu_torch/drivers/
device_bulk.py — the fill, then host-driven rounds, through the same
driver functions — on the JAX package's DeviceBulkCluster with the same
constructor arguments, on the CPU, and prints one JSON object per
config: per round the stats that chip_smoke.py checks, and the sha256 of
the final `pu` array (int32 bytes). These are chip_smoke.py's REF_BULK
constants. About 30 s and 1.1 GB for all three configs.
"""

import hashlib
import json
import sys

import numpy as np

from ksched_tpu.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster
from ksched_tpu_torch.drivers.device_bulk import cluster_args, run_rounds

#: config -> host-driven rounds after the fill, as chip_smoke.py runs them
ROUNDS = {"coco50k-preempt": 4, "coco50k": 2, "10kx1k": 2}
KEYS = ("placed", "migrated", "preempted", "unscheduled", "objective",
        "supersteps", "converged")


def reference(config: str) -> dict:
    tasks, kw, penalties = cluster_args(config)
    cost_fn = None if penalties is None else coco_device_cost_fn(penalties)
    cluster = DeviceBulkCluster(class_cost_fn=cost_fn, **kw)
    out = {}
    for _r, stats in run_rounds(cluster, tasks, ROUNDS[config]):
        got = cluster.fetch_stats(stats)
        for k in KEYS:
            if k in got:
                out.setdefault(k, []).append(int(got[k]))
    pu = np.asarray(cluster.fetch_state()["pu"], np.int32)
    out["pu_sha256"] = hashlib.sha256(pu.tobytes()).hexdigest()
    return out


def main(argv) -> int:
    for config in argv or list(ROUNDS):
        print(json.dumps({config: reference(config)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
