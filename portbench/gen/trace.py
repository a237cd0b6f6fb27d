"""A synthesized Google cluster trace (clusterdata-2011's schema).

A mix (its traffic file) gives the trace's rates: `rate` task
submissions a second, uniform over the trace, each finishing after an
exponential runtime of mean `mean_runtime_s`, in `jobs`-sized job ids
and one of 4 scheduling classes; a `machine_churn` share of the
machines goes down once, at a uniform time in the middle 70% of the
trace, and comes back after an exponential outage of mean `outage_s`.
With `burst_spike` > 0, the windows whose index is in a burst carry
`burst_spike` times the base rate: `burst_count` bursts of
`burst_windows` windows, placed at fixed shares of the trace (so every
seed has its bursts at the same windows and the same share of burst
windows in any span); with `correlated_outages` > 0, as many blocks of
`outage_block` machines go down together. The trace is `n_windows`
windows of `window_s` seconds long (the configuration's count, the same
in every run).

The arrival times, runtimes, classes, jobs and churn are drawn from
the run's seed. It follows `synthesize_trace` of
`ksched_tpu_torch/drivers/trace_replay.py` (itself modelled on the
Google 2011 trace: Poisson submissions, exponential runtimes, machine
outages), vectorized, with bursts placed by window index.
"""

from __future__ import annotations

import numpy as np

SUBMIT, FINISH = 0, 4
MACHINE_ADD, MACHINE_REMOVE = 0, 1


class TaskEvent:
    __slots__ = ("time_us", "job_id", "task_index", "event_type", "scheduling_class")

    def __init__(self, time_us, job_id, task_index, event_type, scheduling_class):
        self.time_us, self.job_id, self.task_index = time_us, job_id, task_index
        self.event_type, self.scheduling_class = event_type, scheduling_class


class MachineEvent:
    __slots__ = ("time_us", "machine_id", "event_type")

    def __init__(self, time_us, machine_id, event_type):
        self.time_us, self.machine_id, self.event_type = time_us, machine_id, event_type


def burst_windows(mix: dict, n_windows: int) -> np.ndarray:
    """bool[n_windows]: the windows inside a burst, at fixed shares of
    the trace: burst k starts at (k + 1) / (burst_count + 1) of it."""
    out = np.zeros(n_windows, bool)
    if mix.get("burst_spike", 0) > 0:
        n = mix["burst_count"]
        for k in range(n):
            start = (k + 1) * n_windows // (n + 1)
            out[start:start + mix["burst_windows"]] = True
    return out


def _outages(rng, machines, count, duration_us, outage_s, lo, hi, block=1):
    """(times, machine ids, kinds) of `count` outages of `block`
    machines each, starting uniformly in [lo, hi) of the trace."""
    times, ids, kinds = [], [], []
    for _ in range(count):
        t0 = int(rng.uniform(lo, hi) * duration_us)
        down = rng.choice(machines, block, replace=False) + 1
        back = t0 + int(rng.exponential(outage_s) * 1e6)
        times += [t0] * block
        ids += down.tolist()
        kinds += [MACHINE_REMOVE] * block
        if back < duration_us:
            times += [back] * block
            ids += down.tolist()
            kinds += [MACHINE_ADD] * block
    return times, ids, kinds


def synthesize(cfg: dict, mix: dict, seed: int):
    """(machine events, task events) of one seed's trace, each list in
    time order, ties in the order they were made."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0])
    machines, n_windows = cfg["machines"], cfg["n_windows"]
    window_us = int(mix["window_s"] * 1e6)
    duration_us = n_windows * window_us
    times = [0] * machines
    ids = list(range(1, machines + 1))
    kinds = [MACHINE_ADD] * machines
    churn = _outages(rng, machines, int(machines * mix["machine_churn"]), duration_us,
                     mix["outage_s"], 0.1, 0.8)
    blocks = _outages(rng, machines, mix.get("correlated_outages", 0), duration_us,
                      mix["outage_s"], 0.15, 0.85, block=mix.get("outage_block", 1))
    for t, i, k in (churn, blocks):
        times, ids, kinds = times + t, ids + i, kinds + k
    order = np.argsort(np.asarray(times, np.int64), kind="stable")
    m_events = [MachineEvent(int(times[j]), int(ids[j]), int(kinds[j])) for j in order]

    # submissions: each window's count at its rate (bursts at the spike)
    base = mix["rate"] * mix["window_s"]
    rate = np.where(burst_windows(mix, n_windows), base * mix.get("burst_spike", 1.0), base)
    counts = rng.poisson(rate)
    n = int(counts.sum())
    win = np.repeat(np.arange(n_windows), counts)
    arrive = win * window_us + rng.integers(0, window_us, n)
    arrive.sort()
    run = (rng.exponential(mix["mean_runtime_s"], n) * 1e6).astype(np.int64)
    jobs = rng.integers(1, max(2, n // 50), n)
    cls = rng.integers(0, 4, n)
    t_all = np.concatenate([arrive, arrive + run])
    made = np.concatenate([2 * np.arange(n), 2 * np.arange(n) + 1])
    order = np.lexsort((made, t_all))
    task = order % n
    kind = np.where(order < n, SUBMIT, FINISH)
    t_events = [TaskEvent(int(t), int(j), int(i), int(k), int(c) if k == SUBMIT else 0)
                for t, j, i, k, c in zip(t_all[order], jobs[task], task, kind, cls[task])]
    return m_events, t_events


def penalties(cfg: dict) -> np.ndarray:
    """int64[machines, 4]: each machine's CoCo penalty for an incoming
    task of each class, in [0, penalty_max): the deployment's own, drawn
    from its data_seed."""
    rng = np.random.default_rng(cfg["data_seed"])
    return rng.integers(0, cfg["penalty_max"], (cfg["machines"], 4)).astype(np.int64)


def window_offsets(seed: int, n: int) -> np.ndarray:
    """int32[n]: each window's decode-window rotation, from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    return rng.integers(0, 1 << 30, n).astype(np.int32)
