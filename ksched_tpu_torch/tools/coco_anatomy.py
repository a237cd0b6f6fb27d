"""The round-floor anatomy of the coco50k steady config on the card.

The port of ksched_tpu's tools/coco_anatomy.py (:26-83): four variants
of coco50k's steady rounds through the port's bench protocol
(bench.py `_device_bench`), each on its own cluster:

  baseline             the suite's coco50k cluster with a 4096-row decode
                       window
  uncontended-slots32  slots doubled (occupancy ~39%): supersteps
                       collapse, the residual is the census + cost +
                       decode + bookkeeping floor
  decode-512 / decode-8192
                       the [width, M] mover-ranking term, by slope

with the JAX tool's penalties (default_rng(0)), 50k tasks on 1k
machines x 4 PUs, 20 jobs, 4 classes, 128 rounds in chunks of 32.
Prints one JSON line: per variant its p50, supersteps p50, the latency
model's fixed cost and slope and the chunk walls, and a floor
decomposition from the four p50s.

Usage: python -m ksched_tpu_torch.tools.coco_anatomy [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np

#: (name, slots a PU, decode width)
VARIANTS = (
    ("baseline", 16, 4096),
    ("uncontended-slots32", 32, 4096),
    ("decode-512", 16, 512),
    ("decode-8192", 16, 8192),
)


def variant_cluster(slots: int, decode_width: int, tasks: int, machines: int, device):
    """A coco50k cluster at `slots` slots a PU and `decode_width`, priced
    with the tool's penalties."""
    from ..costmodels import coco
    from ..costmodels.device_costs import coco_device_cost_fn
    from ..scheduler.device_bulk import DeviceBulkCluster
    from ..utils import next_pow2

    penalties = np.random.default_rng(0).integers(0, 40, (machines, 4)).astype(np.int64)
    return DeviceBulkCluster(
        num_machines=machines, pus_per_machine=4, slots_per_pu=slots, num_jobs=20,
        num_task_classes=4, task_capacity=next_pow2(tasks + 4096),
        class_cost_fn=coco_device_cost_fn(penalties), unsched_cost=coco.UNSCHEDULED_COST,
        ec_cost=0, supersteps=1 << 17, decode_width=decode_width, device=device)


def run(device="cuda", tasks: int = 50_000, machines: int = 1_000, rounds: int = 128,
        chunk: int = 32, log=None) -> dict:
    """The four variants on `device`; `tasks`, `machines`, `rounds` and
    `chunk` cut the size for a check on the CPU."""
    from ..bench import _device_bench

    out = {}
    for name, slots, width in VARIANTS:
        rec = _device_bench(variant_cluster(slots, width, tasks, machines, device),
                            tasks=tasks, churn=0.01, rounds=rounds, chunk=chunk,
                            label=f"coco50k anatomy/{name}")
        d = rec["detail"]
        lm = d.get("latency_model") or {}
        out[name] = {
            "p50_ms": rec["value"],
            "supersteps_p50": d.get("supersteps_p50"),
            "fixed_ms": lm.get("fixed_ms"),
            "per_superstep_us": lm.get("per_superstep_us"),
            "chunks_wall_ms": d.get("chunks_wall_ms"),
        }
        if log is not None:
            log(f"# {name}: p50 {rec['value']} ss_p50 {d.get('supersteps_p50')}")
    base = out["baseline"]["p50_ms"]
    unc = out["uncontended-slots32"]["p50_ms"]
    d512 = out["decode-512"]["p50_ms"]
    d8192 = out["decode-8192"]["p50_ms"]
    # decode slope per 1k width from the 512 -> 8192 spread
    decode_slope = (d8192 - d512) / (8192 - 512) * 1024
    out["decomposition"] = {
        "solve_plus_contention_ms": round(base - unc, 4),
        "decode_per_1024_width_ms": round(decode_slope, 4),
        "decode_at_4096_ms_est": round(decode_slope * 4, 4),
        "residual_floor_ms_est": round(unc - decode_slope * 4, 4),
    }
    return out


def main(argv=None, log=print, err=functools.partial(print, file=sys.stderr)) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.coco_anatomy")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    log(json.dumps(run(args.device, log=err)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
