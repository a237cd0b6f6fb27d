"""The Google-trace replay configs of ksched_tpu's bench.py suite.

BASELINE config 5, a replay of a synthesized Google 2011 trace
(drivers/trace_replay.py synthesize_trace) at 12,500 machines, with
bench.py's own arguments:

- ``gtrace12k``, ``gtrace12k-burst`` and ``gtrace12k-coco``
  (bench.py:2203-2340, its card branch): 1 s windows, seed 11, machine
  churn 0.02, mean runtime 120 s, 64 jobs, through
  DeviceTraceReplayDriver on DeviceBulkCluster.
  - ``gtrace12k``: 100 arrivals a second, 8 slots a machine, Tcap 32,768,
    decode width 1024; per-job escape costs, so every window is the
    row-constant closed form (no kernel);
  - ``gtrace12k-burst``: the same with Tcap 65,536, decode width 2048,
    and arrival bursts at 6x the rate (burst_count n_windows // 340,
    30 s each) and 4 correlated outages of 2% of the fleet;
  - ``gtrace12k-coco``: 160 arrivals a second, 2 slots a machine (about
    76% of the 25,000 slots live), Tcap 32,768, decode width 1024, the
    CoCo interference model over the 4 classes with penalties
    default_rng(7).integers(0, 40, (12500, 4)), 1 << 17 supersteps:
    every window runs the iterative transport at [4, 12,544], kernel B1
    on the card.

  The one cut: the trace is 1,024 windows long where bench.py's card
  run stages 12,288 (N_WINDOWS). Above 512 windows the burst length
  stays bench.py's card value of 30 s, and the burst count is 3.
- ``gtrace12k-host`` (bench.py:1736-1760): 60,000 tasks over 600 s in
  5 s windows, 60 rounds, through TraceReplayDriver on the host
  BulkCluster with a LayeredTransportSolver, 8 slots a machine. No cut.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..costmodels import coco
from ..costmodels.device_costs import coco_device_cost_fn
from .device_bulk import stats_sha256
from .trace_replay import DeviceTraceReplayDriver, TraceReplayDriver, synthesize_trace

N_MACHINES = 12_500
WINDOW_S = 1.0
#: the replayed trace's length: bench.py's card run stages 12,288
#: windows; this cut is the configs' only reduction
N_WINDOWS = 1_024
SEED = 11
MACHINE_CHURN = 0.02
MEAN_RUNTIME_S = 120.0
NUM_JOBS = 64
#: the replayed windows: CHUNKS calls of CHUNK_WINDOWS windows each (the
#: first 512 of the staged windows: a cut that keeps the smoke's three
#: cells inside its time)
CHUNKS, CHUNK_WINDOWS = 2, 256
#: the stats a chunk summary sums
SUMMARY = ("placed", "evicted", "admitted", "completed", "unscheduled")

#: name -> (arrival rate a second, DeviceTraceReplayDriver arguments;
#: "burst" adds bench.py's burst statistics, "cost": "coco" the CoCo
#: policy)
GTRACE = {
    "gtrace12k": (100.0, dict(slots_per_machine=8, task_capacity=1 << 15,
                              decode_width=1024)),
    "gtrace12k-burst": (100.0, dict(slots_per_machine=8, task_capacity=1 << 16,
                                    decode_width=2048, burst=True)),
    "gtrace12k-coco": (160.0, dict(slots_per_machine=2, task_capacity=1 << 15,
                                   decode_width=1024, cost="coco")),
}

#: gtrace12k-host: synthesize_trace's arguments, then the replay's
HOST_TRACE = dict(num_machines=N_MACHINES, num_tasks=60_000, duration_s=600.0,
                  seed=SEED, machine_churn=MACHINE_CHURN)
HOST_REPLAY = dict(window_s=5.0, max_rounds=60)
HOST_SLOTS = 8


def trace_args(config: str, n_windows: int = N_WINDOWS, n_machines: int = N_MACHINES,
               rate=None) -> dict:
    """synthesize_trace's arguments for a gtrace config at `n_windows`
    windows on `n_machines` machines (N_WINDOWS and N_MACHINES by
    default) at `rate` arrivals a second (the config's by default), as
    bench.py derives them (bench.py:2303-2320)."""
    rate0, kw = GTRACE[config]
    rate = rate0 if rate is None else rate
    duration_s = n_windows * WINDOW_S
    out = dict(num_machines=n_machines, num_tasks=int(duration_s * rate),
               duration_s=duration_s, mean_runtime_s=MEAN_RUNTIME_S, seed=SEED,
               machine_churn=MACHINE_CHURN)
    if kw.get("burst"):
        out.update(burst_spike=6.0, burst_count=max(2, n_windows // 340),
                   burst_s=30.0 if n_windows > 512 else 4.0,
                   correlated_outages=4, outage_block=max(8, n_machines // 50))
    return out


def driver_args(config: str, n_machines: int = N_MACHINES, **over) -> tuple:
    """(DeviceTraceReplayDriver arguments without the cost function and
    the device, and the CoCo penalties for `n_machines` machines or
    None) for a gtrace config; `over` replaces slots_per_machine,
    task_capacity or decode_width (bench.py's --override knobs)."""
    _rate, kw = GTRACE[config]
    kw = dict(kw, num_jobs_hint=NUM_JOBS)
    kw.pop("burst", None)
    penalties = None
    if kw.pop("cost", None) == "coco":
        penalties = np.random.default_rng(7).integers(0, 40, (n_machines, 4)).astype(np.int64)
        kw.update(unsched_cost=coco.UNSCHEDULED_COST, supersteps=1 << 17)
    kw.update(over)
    return kw, penalties


def gtrace_driver(config: str, device="cuda", n_windows: int = N_WINDOWS,
                  n_machines: int = N_MACHINES, rate=None, **over) -> tuple:
    """(DeviceTraceReplayDriver of a gtrace config on `device`, the
    trace's task events); the keywords as trace_args and driver_args
    take them."""
    machines, events = synthesize_trace(**trace_args(config, n_windows, n_machines, rate))
    kw, penalties = driver_args(config, n_machines, **over)
    cost_fn = None if penalties is None else coco_device_cost_fn(penalties)
    return DeviceTraceReplayDriver(machines, class_cost_fn=cost_fn, device=device,
                                   **kw), events


def window_slice(schedule: dict, i0: int, k: int) -> dict:
    """Windows [i0, i0 + k) of a staged schedule (bench.py's
    slice_schedule)."""
    return {key: (v[i0:i0 + k] if isinstance(v, np.ndarray) else v)
            for key, v in schedule.items()}


def replay_chunks(driver, schedule: dict):
    """Replay the first CHUNKS * CHUNK_WINDOWS staged windows in CHUNKS
    calls of CHUNK_WINDOWS windows, seeds 1, 2, ...: yields (chunk
    index, its un-fetched stats). The window offsets of a call depend on
    its window count, so every replay that is compared chunks alike."""
    for c in range(CHUNKS):
        yield c, driver.replay(window_slice(schedule, c * CHUNK_WINDOWS, CHUNK_WINDOWS),
                               seed=1 + c)


def chunk_summary(stats: dict) -> dict:
    """A replayed chunk's fetched stats summed: SUMMARY's counts,
    supersteps max and p50, whether every window converged, `live` after
    its last window, and the sha256 of all its stats."""
    ss = np.asarray(stats["supersteps"])
    out = {k: int(np.asarray(stats[k]).sum()) for k in SUMMARY}
    out.update(supersteps_max=int(ss.max()), supersteps_p50=int(np.percentile(ss, 50)),
               converged=bool(np.asarray(stats["converged"]).all()),
               live_last=int(np.asarray(stats["live"])[-1]),
               stats_sha256=stats_sha256(stats))
    return out


def host_driver(backend) -> tuple:
    """(TraceReplayDriver of gtrace12k-host on `backend`, the trace's
    task events)."""
    machines, events = synthesize_trace(**HOST_TRACE)
    return TraceReplayDriver(machines, backend=backend, slots_per_machine=HOST_SLOTS), events


def placements_sha256(cluster) -> str:
    """sha256 of a host BulkCluster's task_pu (int32 bytes)."""
    return hashlib.sha256(np.asarray(cluster.task_pu, np.int32).tobytes()).hexdigest()
