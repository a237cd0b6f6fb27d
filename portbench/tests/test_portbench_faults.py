"""`correct` comes out false when the timed path is broken underneath.

Each case drives a whole run of a cell on the CPU at a small size (past
the harness's look for a card) with the program's round broken in one
way the cell can be: a round that returns the cluster's state
unchanged, a round that schedules only half of its backlog, and an
answer altered where the decode produces it (two placements swapped).
The controls fail the same way: the reference put in the place of the
program's solve, on costs at twice the cost quantum or greedily, each
drives a whole run whose `correct` comes out false."""

import time

import pytest
import torch

from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster
from portbench import harness
from portbench.control import CONTROLS, in_place
from portbench.tests.small import BURST, GTRACE, QUINCY, REPLAY, STEADY

CELLS = {"quincy10k-multiblock.steady": (QUINCY, STEADY, "steady_round"),
         "gtrace12k-coco.replay": (GTRACE, REPLAY, "replay_round"),
         "gtrace12k-coco.burst": (GTRACE, BURST, "replay_round")}
_orig = {name: getattr(DeviceBulkCluster, name)
         for name in ("steady_round", "replay_round", "_bounded_round", "rank_match_decode")}


def unchanged(entry):
    def round_(self, *args):
        state = self.state
        stats = _orig[entry](self, *args)
        self.state = state
        return stats
    return round_


def half_backlog(self, state, window_offset):
    waiting = state.live & (state.pu < 0)
    hide = waiting & (torch.cumsum(waiting.to(torch.int32), 0) % 2 == 0)
    out, stats = _orig["_bounded_round"](self, state._replace(live=state.live & ~hide),
                                         window_offset)
    return out._replace(live=out.live | hide), stats


def swapped(self, g_safe, grants, pu_free):
    granted, pu_abs = _orig["rank_match_decode"](self, g_safe, grants, pu_free)
    rows = torch.nonzero(granted)[:, 0]
    if rows.numel() >= 2:
        a, b = rows[0], rows[-1]
        pu_abs = pu_abs.clone()
        pu_abs[a], pu_abs[b] = pu_abs[b].clone(), pu_abs[a].clone()
    return granted, pu_abs


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_backlog", "answer_altered"])
def test_a_broken_round_is_not_correct(monkeypatch, cell, fault):
    cfg, mix, entry = CELLS[cell]
    attr, broken = {"state_unchanged": (entry, unchanged(entry)),
                    "half_the_backlog": ("_bounded_round", half_backlog),
                    "answer_altered": ("rank_match_decode", swapped)}[fault]
    monkeypatch.setattr(DeviceBulkCluster, attr, broken)
    line, _faults = harness.run_cell(harness.load_benchmark(), cell, cfg, mix, 5, 0.5,
                                     False, "cpu", time.perf_counter())
    assert line["correct"] is False and line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("control", CONTROLS)
def test_a_control_in_the_programs_place_is_not_correct(cell, control):
    cfg, mix, _entry = CELLS[cell]
    with in_place(control):
        line, _faults = harness.run_cell(harness.load_benchmark(), cell, cfg, mix, 5, 2.0,
                                         False, "cpu", time.perf_counter())
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["gap_max"]["value"] > line["checks"]["gap_max"]["limit"]
