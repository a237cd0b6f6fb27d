"""The plain reference of a trace-replay window under CoCo.

A trace is replayed in fixed windows of simulated time, one scheduling
round a window. This module works out again, from the trace alone, what
each window hands the scheduler:

- `stage`: the windows (a window closes at the first event past its
  end; machine events up to its end apply to it), each task's net
  effect in its window (a submit opens a row, a finish closes the
  task's row; a task both submitted and finished inside one window is
  admitted and retires in the next window), and the row each admitted
  task takes: the lowest free rows, in order, as the cluster admits.
- `Follower`, which follows the program window by window from the
  placements it read back after the window before: machines toggled
  (the tasks of a machine going down evicted), completions retired,
  admissions placed in rows, the decode window, and the CoCo costs of
  the round: for an incoming task of class c on machine m,
  min(sum_k W[c, k] * census[m, k] + penalty[m, c], max_cost), census
  the classes running on m, less the escape cost. It judges the
  program's placements as every round is judged (rounds.py).
"""

from __future__ import annotations

import numpy as np

from ..gen.trace import (FINISH, MACHINE_ADD, MACHINE_REMOVE, SUBMIT, penalties,
                         synthesize, window_offsets)
from . import rounds

#: finish-kind events: finish, evict, fail, kill, lost
_ENDS = (FINISH, 2, 3, 5, 6)


def _net_ops(events, is_live):
    """(retires, admits, pairs) of one window: keys whose existing row
    closes, submits whose new row survives the window, and submits that
    also finish inside it; a submit for a live key and a finish for a
    dead one change nothing."""
    seq, order = {}, []
    for ev in events:
        key = (ev.job_id, ev.task_index)
        if key not in seq:
            seq[key] = []
            order.append(key)
        seq[key].append(ev)
    retires, admits, pairs = [], [], []
    for key in order:
        live = pre_row = is_live(key)
        opened = None
        for ev in seq[key]:
            if ev.event_type == SUBMIT:
                if not live:
                    live, opened = True, ev
            elif live:
                live = False
                if pre_row:
                    retires.append(key)
                    pre_row = False
                else:
                    pairs.append(opened)
                opened = None
        if live and opened is not None:
            admits.append(opened)
    return retires, admits, pairs


def stage(machine_events, task_events, window_s: float, max_windows: int,
          task_capacity: int, jobs: int):
    """The windows of a trace: [(toggles [(machine index, on)], done
    rows, admissions [(row, job, class)])]."""
    index = {}
    for ev in machine_events:
        index.setdefault(ev.machine_id, len(index))
    live = np.zeros(task_capacity, bool)
    row_of, carry, windows = {}, [], []
    toggles, cursor = {}, 0

    def machines_until(t):
        nonlocal cursor
        while cursor < len(machine_events) and machine_events[cursor].time_us <= t:
            ev = machine_events[cursor]
            cursor += 1
            if ev.event_type in (MACHINE_ADD, MACHINE_REMOVE):
                toggles[index[ev.machine_id]] = ev.event_type == MACHINE_ADD

    def flush(events):
        nonlocal carry, toggles
        retires, admits, pairs = _net_ops(events, lambda k: k in row_of)
        done = carry + [row_of.pop(k) for k in retires]
        live[done] = False
        carry = []
        fresh = admits + pairs
        free = np.nonzero(~live)[0][:len(fresh)]
        adm = []
        for i, (ev, row) in enumerate(zip(fresh, free)):
            live[row] = True
            if i < len(admits):
                row_of[(ev.job_id, ev.task_index)] = int(row)
            else:
                carry.append(int(row))
            adm.append((int(row), ev.job_id % jobs, ev.scheduling_class % 4))
        windows.append((sorted(toggles.items()), done, adm))
        toggles = {}

    window_us = int(window_s * 1e6)
    pending, end = [], None
    for ev in task_events:
        if end is None:
            end = ev.time_us + window_us
            machines_until(ev.time_us)
        while ev.time_us >= end:
            if pending:
                machines_until(end)
                flush(pending)
                pending = []
                if len(windows) >= max_windows:
                    return windows
            end += window_us
        if ev.event_type == SUBMIT or ev.event_type in _ENDS:
            pending.append(ev)
    if pending:
        flush(pending)
    if carry and len(windows) < max_windows:
        flush([])
    return windows


class Follower:
    """Follows the program's windows (see the module's docstring). Feed
    it round(i, pu) in order; each appends its reading to `readings`."""

    def __init__(self, cfg: dict, mix: dict, seed: int, trace=None):
        self.cfg = cfg
        machines, tasks = trace or synthesize(cfg, mix, seed)
        self.windows = stage(machines, tasks, mix["window_s"], cfg["n_windows"],
                             cfg["task_capacity"], cfg["jobs"])
        self.offsets = window_offsets(seed, len(self.windows))
        self.M, self.S = cfg["machines"], cfg["slots"]
        self.W = np.asarray(cfg["interference"], np.int64)
        self.pen = penalties(cfg)
        T = cfg["task_capacity"]
        self.live = np.zeros(T, bool)
        self.cls = np.zeros(T, np.int64)
        self.pu = np.full(T, -1, np.int64)
        self.enabled = np.zeros(self.M, bool)
        self.readings = []
        self.control_readings = []

    def round(self, i: int, pu_after, judge: bool = True, control: bool = False):
        toggles, done, adm = self.windows[i]
        for m, on in toggles:
            self.enabled[m] = on
        placed = self.live & (self.pu >= 0)
        self.pu[placed & ~self.enabled[np.clip(self.pu, 0, self.M - 1)]] = -1
        gone = np.zeros_like(self.live)
        gone[done] = True
        gone &= self.live
        self.live &= ~gone
        self.pu[gone] = -1
        for row, _job, cls in adm:
            self.live[row], self.cls[row], self.pu[row] = True, cls, -1
        backlog = np.nonzero(self.live & (self.pu < 0))[0]
        window = rounds.window_of(backlog, self.cfg["decode_width"], int(self.offsets[i]))
        if control:
            _act, supply, free, w = self.instance(window)
            self.control_readings.append(dict(rounds.controls(w, supply, free), round=i))
        post = np.asarray(pu_after, np.int64)
        found = rounds.faults(self.pu, post, self.live, window, self.M, self.S,
                              enabled_pu=self.enabled)
        gap = None
        if judge and not found:
            act, supply, free, w = self.instance(window)
            gap = rounds.gap(w, supply, free,
                             rounds.new_flow(window, post, self.cls, act, self.M, 1))
        placed_now = int((post[window] >= 0).sum()) if post.shape == self.pu.shape else -1
        self.readings.append({"round": i, "gap": gap, "faults": found, "placed": placed_now})
        self.pu = post.copy()

    def instance(self, window):
        """The window's transport: (active classes, their supply, the
        machines' free slots, the costs w[active, M])."""
        act, supply = np.unique(self.cls[window], return_counts=True)
        on = self.live & (self.pu >= 0)
        census = np.zeros((self.M, 4), np.int64)
        np.add.at(census, (self.pu[on], self.cls[on]), 1)
        free = np.where(self.enabled, self.S - census.sum(axis=1), 0)
        cost = np.minimum(census @ self.W.T + self.pen, self.cfg["max_cost"])  # [M, 4]
        return act, supply, free, cost.T[act] - self.cfg["unsched_cost"]


def judge(cfg, mix, seed, events, sample=None, control=()) -> Follower:
    """Follow a run's events and judge its windows: every window's
    placements for faults, and the gap of those in `sample` (all when
    None); the windows in `control` also get the controls' readings.
    The events may start with the trace the program was handed."""
    trace = events[0][1:] if events and events[0][0] == "trace" else None
    follower = Follower(cfg, mix, seed, trace)
    control = set(control)
    for ev in events:
        if ev[0] == "round":
            i = ev[1]
            follower.round(i, ev[2], judge=sample is None or i in sample,
                           control=i in control)
    return follower


#: the share of windows whose gap to the optimum is judged, drawn from
#: the seed, beside the windows whose solves took the most supersteps
SAMPLE_SHARE, LONGEST = 0.25, 32


def verdict(cfg: dict, mix: dict, seed: int, events, counts: dict) -> dict:
    """`correct` for a run: every window (the warm-up and the measured
    ones) judged for faults, and for its gap to the optimum a sample:
    a quarter of them drawn from the seed and the LONGEST window rounds
    by supersteps (rounds.verdict)."""
    rounds_run = [ev[1] for ev in events if ev[0] == "round"]
    rng = np.random.default_rng([int(seed) % (1 << 64), 4])
    sample = set(rng.choice(rounds_run, int(len(rounds_run) * SAMPLE_SHARE),
                            replace=False).tolist())
    window = rounds_run[len(rounds_run) - len(counts["supersteps"]):]
    longest = np.argsort(-counts["supersteps"], kind="stable")[:LONGEST]
    sample |= {window[j] for j in longest}
    return rounds.verdict(judge(cfg, mix, seed, events, sample=sample).readings, counts)
