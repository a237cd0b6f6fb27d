"""Times the transport kernels (B1 `transport_loop`, B2
`transport_loop_tiered`) on the main path's own solves, so that two
checkouts of the port can be compared on one card in one run.

    python3 transport_timing.py capture SOLVES.pt
    python3 transport_timing.py time SOLVES.pt [--root CHECKOUT] [--reps N]

`capture` runs, on the card, Scenario W(1000, 10000) through the
default backend (B1's iterative solves), `coco50k-preempt` (fill and 4
host-driven rounds, B2) and `coco50k` (fill and 2 rounds, B1) through
DeviceBulkCluster, and saves every kernel solve's inputs and outputs.
`time` imports `ksched_tpu_torch` from CHECKOUT (default: this
directory), builds its kernels, checks that each saved solve gives the
saved outputs bit for bit, and prints one JSON line per solve: its
mean time over N launches (CUDA events, after a warm-up launch), time
per superstep and, where the checkout's wrappers take `cycles`, the
phase probe's split of one more launch. Both modes need a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Wraps ops.<name> while a scenario runs: keeps each solve's inputs
    and outputs on the CPU."""

    def __init__(self, ops, name, scenario, into):
        self.ops, self.name, self.scenario, self.into = ops, name, scenario, into
        self.inner = getattr(ops, name)

    def __enter__(self):
        setattr(self.ops, self.name, self)

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.inner)

    def __call__(self, *args, **kw):
        import torch

        out = self.inner(*args, **kw)

        def cpu(a):
            return a.detach().cpu().clone() if isinstance(a, torch.Tensor) else a

        self.into.append({"kernel": self.name, "scenario": self.scenario,
                          "args": [cpu(a) for a in args], "kw": dict(kw),
                          "out": [cpu(t) for t in out]})
        return out


def capture(path: str) -> None:
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.drivers.device_bulk import device_cluster, run_rounds

    solves = []
    with Capture(ops, "transport_solve", "W(1000,10000)", solves):
        for _r in whare_mixed_rounds(1000, 10000, backend=None):
            pass
    for config, rounds in (("coco50k-preempt", 4), ("coco50k", 2)):
        cluster, tasks = device_cluster(config, device="cuda")
        with Capture(ops, "transport_solve", config, solves), \
                Capture(ops, "transport_solve_tiered", config, solves):
            for _r, stats in run_rounds(cluster, tasks, rounds):
                cluster.fetch_stats(stats)
    import torch

    torch.save(solves, path)
    print(json.dumps({"captured": len(solves), "path": path}))


def time_solves(path: str, reps: int) -> None:
    import torch

    from ksched_tpu_torch.ops import transport

    dev = torch.device("cuda", 0)
    solves = torch.load(path, weights_only=False)
    kernels = {"transport_solve": transport.transport_loop,
               "transport_solve_tiered": transport.transport_loop_tiered}
    slots = getattr(transport, "PROBE_SLOTS", None)
    print(json.dumps({"card": card_line(), "package": transport.__file__}))
    for i, s in enumerate(solves):
        fn = kernels[s["kernel"]]
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in s["args"]]

        def run(**extra):
            return fn(*args, **s["kw"], **extra)

        got = run()
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, s["out"]))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        steps = int(s["out"][2])
        row = {"solve": i, "kernel": s["kernel"], "scenario": s["scenario"],
               "shape": list(s["args"][0].shape), "steps": steps, "same_bits": same,
               "ms": ms, "us_per_step": 1e3 * ms / max(steps, 1)}
        if slots is not None:
            cycles = torch.zeros(len(slots), dtype=torch.int64, device=dev)
            run(cycles=cycles)
            c = dict(zip(slots, cycles.tolist()))
            row["cycles_per_step"] = {k: c[k] / max(steps, 1) for k in slots}
            row["share"] = {k: c[k] / c["total"] for k in slots[:-1]}
        print(json.dumps(row), flush=True)
        if not same:
            raise SystemExit(f"solve {i}: the kernel's outputs differ from the saved ones")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("capture", "time"))
    p.add_argument("path")
    p.add_argument("--root", default=str(Path(__file__).resolve().parent),
                   help="the checkout whose ksched_tpu_torch to time")
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("transport_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(a.root).resolve()))
    if a.mode == "capture":
        capture(a.path)
    else:
        time_solves(a.path, a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
