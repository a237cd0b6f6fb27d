"""The controls of `correct`: whole runs with the reference's solve put in
the place of the program's, each judged by the run's own comparison.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--controls half_quantum,greedy] [--out chiprun_out/control.jsonl]

A control is the reference's transport put where the program solves a
round: `half_quantum` solves it on costs at twice the cost quantum
(w >> 1), as a program that halved the cost resolution to shorten its
solves would place; `greedy` sends each row to its cheapest machines
with room, as a program without the solve would. Census, costs, decode
and apply stay the program's, so the run's comparison (the reference's
verdict, at the configuration's quantum) judges the control's
placements as it judges the program's. For each seed and control: one
run of the cell at its own load, as `portbench.run` makes it, and one
JSON line with `correct` and each number compared beside its limit.
The benchmark's own runs do not run the controls.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

CONTROLS = ("half_quantum", "greedy")


def placement(kind: str, w, supply, free):
    """The control's flow y[G, M] for a round (w int[G, M], the escape at
    0; supply int[G]; free int[M])."""
    from .reference import transport

    w, supply, free = (x.cpu().numpy().astype(np.int64) for x in (w, supply, free))
    if kind == "half_quantum":
        return transport.solve(w >> 1, supply, free)
    if kind == "greedy":
        return transport.greedy(w, supply, free)
    raise ValueError(f"no control {kind!r}")


def _padded_flow(cluster, y_real, supply):
    """[G, M] -> the program's [G, Mp] flow, the rest on the escape."""
    import torch

    y = torch.zeros((y_real.shape[0], cluster.Mp), dtype=torch.int32)
    y[:, :cluster.M] = torch.as_tensor(y_real, dtype=torch.int32)
    y[:, cluster.Mp - 1] = supply.cpu() - y[:, :cluster.M].sum(dim=1, dtype=torch.int32)
    return y.to(supply.device)


@contextmanager
def in_place(kind: str):
    """The program's solve replaced by control `kind` while the context
    is open: the grouped solve (group mode) and the class rows' bounded
    solve, each given the round's costs, supplies and free slots as the
    program computed them."""
    import torch

    from ksched_tpu_torch.scheduler import device_bulk
    from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster

    current = []

    def steps_and_flag(like):
        return (torch.zeros((), dtype=torch.int32, device=like.device),
                torch.ones((), dtype=torch.bool, device=like.device))

    def grouped(self, w, wS, supply, total, col_cap, machine_free, ss_budget):
        y = placement(kind, w, supply, machine_free)
        return (_padded_flow(self, y, supply), *steps_and_flag(supply), True)

    def bounded(wS, supply, col_cap, num_supersteps, **_kw):
        cluster = current[-1]
        w = wS[:, :cluster.M] // cluster.n_scale
        y = placement(kind, w, supply, col_cap[:cluster.M])
        return (_padded_flow(cluster, y, supply), torch.zeros_like(col_cap),
                *steps_and_flag(supply), True)

    core = DeviceBulkCluster._round_core

    def round_core(self, *args, **kw):
        current.append(self)
        try:
            return core(self, *args, **kw)
        finally:
            current.pop()

    saved = [(DeviceBulkCluster, "_grouped_solve", grouped),
             (DeviceBulkCluster, "_round_core", round_core),
             (device_bulk, "transport_fori", bounded)]
    saved = [(obj, name, getattr(obj, name), new) for obj, name, new in saved]
    for obj, name, _old, new in saved:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old, _new in saved:
            setattr(obj, name, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default=",".join(CONTROLS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench import harness

    bench = harness.load_benchmark()
    _cell, cfg, mix = harness.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind in args.controls.split(","):
            with in_place(kind):
                line, _faults = harness.run_cell(bench, args.workload, cfg, mix, seed,
                                                 args.seconds, False, "cuda",
                                                 time.perf_counter())
            out = json.dumps({"workload": args.workload, "seed": seed, "control": kind,
                              "correct": line["correct"], "attempted": line["attempted"],
                              "failed": line["failed"], "checks": line["checks"]})
            print(out, flush=True)
            if args.out:
                with Path(args.out).open("a") as f:
                    f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
