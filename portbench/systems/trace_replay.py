"""The port's trace replay under CoCo, driven one window at a time.

The system under test is `ksched_tpu_torch`'s device-resident cluster
fed by its trace stager (`drivers/trace_replay.py`
DeviceTraceReplayDriver: `stage` turns the trace into per-window
arrays, `scheduler/device_bulk.py` `replay_round` runs one window), with
the CoCo interference costs (`costmodels/device_costs.py`
`coco_device_cost_fn`) over the machines' penalties. Set-up synthesizes
the trace from the seed, stages it (timed as `stage_s`), copies the
staged windows and each window's decode rotation to the card once, and
replays the mix's warm-up windows. A round is one window: it starts as
its arrays are handed to `replay_round` and ends when the program's
placements are on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu_torch.drivers.trace_replay import DeviceTraceReplayDriver
from ksched_tpu_torch.scheduler.device_bulk import REPLAY_ARRAYS

from ..gen.trace import penalties, synthesize, window_offsets


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix = cfg, mix
        self.device = torch.device(device)
        machines, tasks = synthesize(cfg, mix, seed)
        self.driver = DeviceTraceReplayDriver(
            machines, slots_per_machine=cfg["slots"], num_jobs_hint=cfg["jobs"],
            task_capacity=cfg["task_capacity"], decode_width=cfg["decode_width"],
            class_cost_fn=coco_device_cost_fn(penalties(cfg)),
            unsched_cost=cfg["unsched_cost"], supersteps=cfg["supersteps"],
            device=self.device)
        self.cluster = self.driver.cluster
        t0 = time.perf_counter()
        sch = self.driver.stage(tasks, window_s=mix["window_s"], max_rounds=cfg["n_windows"])
        self.stage_s = time.perf_counter() - t0
        self.windows = int(sch["rounds"])
        self.arrays = [torch.as_tensor(np.asarray(sch[k]), device=self.device)
                       for k in REPLAY_ARRAYS]
        self.offsets = torch.as_tensor(window_offsets(seed, self.windows), device=self.device)
        #: what the reference reads: the trace (the same objects the
        #: program staged), then each window's placements
        self.events = [("trace", machines, tasks)]
        #: each window's stats (device tensors), from the window's start
        self.stats = []
        #: the harness's spans: the staging's seconds
        self.spans = {"stage_s": self.stage_s}
        self.r = 0

    def setup(self) -> None:
        """The mix's warm-up windows."""
        for _ in range(self.mix["warmup_windows"]):
            self.step()
        self.stats.clear()

    def step(self):
        """The next window. Returns its latency in seconds: from its
        arrays handed to the program to its placements on the host."""
        i = self.r
        if i >= self.windows:
            raise RuntimeError(f"the trace's {self.windows} windows are spent")
        t0 = time.perf_counter()
        stats = self.cluster.replay_round(*(a[i] for a in self.arrays), self.offsets[i])
        pu = self.cluster.state.pu.to("cpu", copy=True).numpy()
        dt = time.perf_counter() - t0
        self.events.append(("round", i, pu))
        self.stats.append(stats)
        self.r += 1
        return dt

    def close(self) -> None:
        """Drop the program's state from the card."""
        self.driver = self.cluster = self.arrays = self.offsets = None
        self.stats = []
