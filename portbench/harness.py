"""One run of one cell: set-up, the measured window, the check, a line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by the names in
`BENCHMARK.json`:

- `configs/<config>.json`: the deployment's sizes, with `system` (the
  module of `systems/` that drives the program) and `reference` (the
  module of `reference/` that judges its output);
- `traffic/<mix>.json`: the mix's parameters;
- `metrics/<metric>.py`: a `read(ctx)` that returns the metric's value
  or None when the run has nothing to read for it.

A run is a closed loop, one round at a time: a round starts when its
draws are handed to the program and ends when its placements are on the
host; the next starts after that. The window takes every round that
starts within `seconds`. End-to-end metrics come from the host clock
over all of the window's rounds; per-layer metrics, in a `--trace 1`
run, from the program's counters, the harness's spans and the
profiler's capture of the window. The reference then follows the run's
events and judges every round.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "ksched_tpu")


def load_benchmark(path=None) -> dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str):
    """(the cell, its configuration's file, its mix's file)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    cell = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (so `ksched_tpu_torch` is not `ksched_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or
    with trace its per-layer ones; an entry with `workloads` is the
    listed cells' alone."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(lat_s, placed: int, window_s: float, setup_s: float) -> dict:
    """The end-to-end numbers of a window: round latency's median and
    95th percentile over all its rounds, the tasks bound over all its
    seconds, and the set-up."""
    return {"round_ms_p50": percentile(lat_s, 50) * 1e3,
            "round_ms_p95": percentile(lat_s, 95) * 1e3,
            "placements_per_s": placed / window_s,
            "setup_s": setup_s}


def read_metric(name: str, ctx: dict):
    path = HERE / "metrics" / f"{name}.py"
    module = "portbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def cell_config(cfg: dict, mix: dict) -> dict:
    """The configuration a cell runs: a mix may size the scheduler's
    buffers for its load, its `scheduler_sizes` replacing the
    configuration's (a task table and a decode window wide enough for
    its bursts)."""
    return dict(cfg, **mix.get("scheduler_sizes", {}))


def window_counts(system) -> dict:
    """The window's program counters, fetched after it, a row a round
    (tasks bound, supersteps), and the system's spans."""
    import torch

    counts = {k: torch.stack([s[k] for s in system.stats]).cpu().numpy().astype(np.int64)
              for k in ("placed", "supersteps")}
    return dict(counts, **system.spans)


def run_cell(bench, cell_name, cfg, mix, seed, seconds, trace, device, t_start):
    """Run cell `cell_name` (configuration `cfg`, mix `mix`) once on
    `device`, the clock of its set-up started at `t_start`; returns
    (the result's line as a dict, the first faults the reference
    found)."""
    import torch

    from .trace import Capture

    cfg = cell_config(cfg, mix)
    device = torch.device(device)
    on_card = device.type == "cuda"
    system = importlib.import_module(f"portbench.systems.{cfg['system']}").System(
        cfg, mix, seed, device)
    system.setup()
    if on_card:
        torch.cuda.synchronize(device)
    # the staged inputs live through the window: a full collection
    # there would walk millions of objects that no round creates
    gc.collect()
    gc.freeze()
    reads0 = host_reads()
    setup_s = time.perf_counter() - t_start
    capture = Capture(device) if trace else None
    lat = []
    with capture.window() if trace else contextlib.nullcontext():
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            lat.append(system.step())
        window_s = time.perf_counter() - w0
    gc.unfreeze()
    reads = host_reads() - reads0
    counts = window_counts(system)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    reduced = capture.reduce() if trace else None
    b1 = capture.b1_launches() if trace else None
    events = system.events
    system.close()
    del system
    if on_card:
        torch.cuda.empty_cache()

    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    check = ref.verdict(cfg, mix, seed, events, counts)
    rounds = len(lat)
    ctx = {"rounds": rounds, "latencies_s": lat, "window_s": window_s,
           "host_reads": reads, "counts": counts, "trace": reduced, "b1": b1,
           "setup_s": setup_s}
    values = end_to_end(lat, int(counts["placed"].sum()), window_s, setup_s)
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        v = values.get(m["name"]) if not trace else read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev["busy_s"], dev["window_s"] = reduced["busy_s"], reduced["window_s"]
    line = {"correct": check["correct"], "attempted": check["attempted"],
            "failed": check["failed"], "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {"device_ops": [list(x) for x in reduced["device_ops"]],
                             "idle_gaps": [list(x) for x in reduced["idle_gaps"]]}
    line["checks"] = check["checks"]
    return line, check["faults"]


def host_reads() -> int:
    """The program's host reads so far: a solve's converged flag
    (`read_flag.count`) and a branch point's predicates
    (`read_branch.count`), in solver/layered.py."""
    from ksched_tpu_torch.solver import layered

    return layered.read_flag.count + layered.read_branch.count


def check_lines(checks: dict) -> list:
    """One line a compared number: its name, value and limit."""
    return [f"check {k} {v['value']} limit {v['limit']}" for k, v in checks.items()]
