"""The port's Quincy scheduler in group mode, driven one round at a time.

The system under test is `ksched_tpu_torch`'s device-resident cluster
(`scheduler/device_bulk.py` DeviceBulkCluster in group mode) with its
Quincy group table (`costmodels/quincy_device.py` QuincyGroupTable).
Set-up registers the deployment's blocks and template pool in the
table, syncs it to the card, admits the fill and schedules it in one
round, then runs the mix's warm-up rounds. A round hands the program
the round's draws (which placed tasks complete, the arriving template
of each row, the decode window's rotation) and ends when the program's
placements are on the host. Every `upkeep_every` rounds the table's
upkeep runs where a scheduler pays it, between rounds: idle groups
reclaimed, templates refreshed, the pool registered again, the table
synced and the arrivals restricted to the pool's groups.

Everything the reference needs is in `events`: the fill's and each
round's placements, in order with the upkeeps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ksched_tpu_torch.costmodels.quincy_device import QuincyGroupTable
from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster

from ..gen.templates import Scenario


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix = cfg, mix
        self.device = torch.device(device)
        self.scenario = Scenario(cfg, seed)
        self.table = QuincyGroupTable(
            num_groups=cfg["num_groups"], num_machines=cfg["machines"],
            cost_unit_mb=cfg["cost_unit_mb"], sig_unit_mb=cfg["sig_unit_mb"])
        for b, (size, holders) in enumerate(zip(self.scenario.block_sizes,
                                                self.scenario.block_holders)):
            self.table.blocks.register(b + 1, size, holders)
        self.cluster = DeviceBulkCluster(
            num_machines=cfg["machines"], pus_per_machine=cfg["pus"],
            slots_per_pu=cfg["slots"], num_jobs=cfg["jobs"],
            task_capacity=cfg["task_capacity"], num_groups=cfg["num_groups"],
            supersteps=cfg["supersteps"], decode_width=cfg["decode_width"],
            active_groups_cap=tuple(cfg["active_groups_cap"]),
            two_stage_eps0=cfg["two_stage_eps0"], device=self.device)
        self.Tcap = cfg["task_capacity"]
        self.zeros = torch.zeros(self.Tcap, dtype=torch.int32, device=self.device)
        self.events = []
        #: each round's stats (device tensors), from the window's start
        self.stats = []
        #: the harness's spans: seconds of each table upkeep in the window
        self.spans = {"group_table_s": []}
        self.r = 0

    def _register_pool(self) -> np.ndarray:
        """Register the template pool, sync the table to the card and
        restrict arrivals to the pool's groups; returns each template's
        group."""
        n = len(self.scenario.templates)
        gids = self.table.groups_for(np.zeros(n, np.int32), self.scenario.templates)
        self.arrival_groups = np.unique(gids)
        self.tmpl_index = np.searchsorted(self.arrival_groups, gids).astype(np.int32)
        self.table.sync(self.cluster)
        self.cluster.set_arrival_groups(self.arrival_groups)
        return gids

    def setup(self) -> None:
        """The pool registered, the fill scheduled, the warm-up rounds."""
        gids = self._register_pool()
        sc = self.scenario
        self.cluster.add_tasks(self.cfg["tasks"], sc.fill_jobs,
                               groups=gids[sc.fill_templates])
        self.cluster.round()
        self.events.append(("fill", self.cluster.state.pu.to("cpu", copy=True).numpy()))
        for _ in range(self.mix["warmup_rounds"]):
            self.step()
        self.stats.clear()
        self.spans["group_table_s"].clear()

    def upkeep(self, k: int) -> None:
        mix = self.mix
        t0 = time.perf_counter()
        st = self.cluster.fetch_state()
        live = np.bincount(st["grp"][st["live"]], minlength=self.table.G)
        self.table.evict_idle(live, keep_fraction=mix["keep_fraction"])
        self.scenario.refresh(k, mix["refresh_templates"])
        self._register_pool()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.spans["group_table_s"].append(time.perf_counter() - t0)
        self.events.append(("upkeep", k))

    def step(self):
        """The next round, after the table's upkeep where one is due.
        Returns the round's latency in seconds: from the draws handed
        to the program to its placements on the host."""
        r, mix = self.r, self.mix
        if r and r % mix["upkeep_every"] == 0:
            self.upkeep(r // mix["upkeep_every"])
        done_u, tmpl, offset = self.scenario.round_draws(r, self.Tcap, mix["churn"])
        draw_a = self.tmpl_index[tmpl]
        dev = self.device
        t0 = time.perf_counter()
        stats = self.cluster.steady_round(
            torch.from_numpy(done_u).to(dev), torch.from_numpy(draw_a).to(dev),
            self.zeros, torch.tensor(offset, dtype=torch.int32, device=dev),
            mix["churn"], mix["arrivals"])
        pu = self.cluster.state.pu.to("cpu", copy=True).numpy()
        dt = time.perf_counter() - t0
        self.events.append(("round", r, pu))
        self.stats.append(stats)
        self.r += 1
        return dt

    def close(self) -> None:
        """Drop the program's state from the card."""
        self.cluster = self.table = self.zeros = None
        self.stats = []
