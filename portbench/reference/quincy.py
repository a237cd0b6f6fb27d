"""The plain reference of a Quincy round: groups, costs, one round.

Quincy (Isard et al., SOSP 2009) prices a task on a machine by the bytes
of its input that it would pull across the network there, and gives it
a preference for each machine that holds more than half of its input.
Tasks whose inputs price them alike form one group and share a row of
the round's transport. This module works all of it out again from the
deployment's blocks and templates, with nothing of the program:

- `Table`, a group table of bounded size: a signature (the input's
  worst-case transfer and its preferred machines, quantized) takes a
  free group on first sight; when none is free it lands in the
  overflow group, priced at the worst transfer among those it holds;
  at upkeep, groups with no live task are reclaimed, least recently
  used first, down to a kept share of the table.
- `Follower`, which follows the program round by round. A round starts
  from the placements the program read back after the round before, so
  a round in which an optimum had ties is judged from where the
  program really stands. It works out the round's completions,
  admissions, decode window, costs and capacities, and judges the
  placements the program read back after it: residents unmoved, every
  placement inside the window and on a slot that exists and has room,
  and the cost of the new placements against the optimum (rounds.py).
"""

from __future__ import annotations

import numpy as np

from ..gen.templates import MB, Scenario
from . import rounds

#: cost units a megabyte pulled across the network costs
COST_PER_MB = 1
#: a machine holding more than this share of a task's input is preferred
PREFERENCE_FRACTION = 0.5
#: "no preference": a route cost no real one reaches
PREF_NONE = 1 << 30


def transfer_cost(total: int, local: int, unit_mb: int) -> int:
    return (COST_PER_MB * max(0, total - local)) // (MB * unit_mb)


class Table:
    """Signature -> group, with the costs of each group: e (the route to
    any machine), u (the escape, e + 1) and pref[G, M] (the preferred
    machines' costs, PREF_NONE elsewhere). Group 0 serves tasks whose
    input costs nothing to move, group 1 is the overflow group."""

    FALLBACK, OVERFLOW = 0, 1

    def __init__(self, cfg: dict, scenario: Scenario):
        self.G, self.M = cfg["num_groups"], cfg["machines"]
        self.cost_unit, self.sig_unit = cfg["cost_unit_mb"], cfg["sig_unit_mb"]
        self.sizes, self.holders = scenario.block_sizes, scenario.block_holders
        self.e = np.zeros(self.G, np.int64)
        self.u = np.ones(self.G, np.int64)
        self.pref = np.full((self.G, self.M), PREF_NONE, np.int64)
        self.sig_of = {}  # signature -> group (the overflow group included)
        self.gid_sig = {}  # registered group -> its signature
        self.overflowed = set()  # signatures held by the overflow group
        self.free = []  # reclaimed groups; the last one is taken first
        self.next = 2
        self.clock = 0
        self.last_use = {}

    def group_for(self, blocks) -> int:
        total, local = 0, {}
        for b in blocks:
            size = self.sizes[b - 1]
            total += size
            for m in self.holders[b - 1]:
                local[m] = local.get(m, 0) + size
        worst = transfer_cost(total, 0, self.cost_unit)
        prefs, sig_prefs = [], []
        for m, b in sorted(local.items()):
            if b > PREFERENCE_FRACTION * total:
                prefs.append((m, transfer_cost(total, b, self.cost_unit)))
                sig_prefs.append((m, transfer_cost(total, b, self.sig_unit)))
        if not prefs and worst == 0:
            return self.FALLBACK
        sig = (transfer_cost(total, 0, self.sig_unit), tuple(sig_prefs))
        self.clock += 1
        gid = self.sig_of.get(sig)
        if gid is not None:
            self.last_use[gid] = self.clock
            if gid == self.OVERFLOW:
                self._price_overflow(worst)
            return gid
        if self.free:
            gid = self.free.pop()
        elif self.next < self.G:
            gid, self.next = self.next, self.next + 1
        else:
            self.sig_of[sig] = self.OVERFLOW
            self.overflowed.add(sig)
            self._price_overflow(worst)
            return self.OVERFLOW
        self.sig_of[sig], self.gid_sig[gid] = gid, sig
        self.last_use[gid] = self.clock
        self.e[gid], self.u[gid] = worst, worst + 1
        self.pref[gid] = PREF_NONE
        for m, cost in prefs:
            self.pref[gid, m] = cost
        return gid

    def _price_overflow(self, worst: int) -> None:
        g = self.OVERFLOW
        self.e[g] = max(self.e[g], worst)
        self.u[g] = self.e[g] + 1

    def evict_idle(self, live_per_group, keep_fraction: float) -> None:
        target = int((self.G - 2) * keep_fraction)
        if len(self.gid_sig) <= target:
            return
        idle = sorted((g for g in self.gid_sig if live_per_group[g] == 0),
                      key=lambda g: self.last_use[g])
        gone = idle[:len(self.gid_sig) - target]
        for g in gone:
            del self.sig_of[self.gid_sig.pop(g)]
            del self.last_use[g]
            self.free.append(g)
            self.e[g], self.u[g] = 0, 1
            self.pref[g] = PREF_NONE
        if gone:
            for sig in self.overflowed:
                self.sig_of.pop(sig, None)
            self.overflowed = set()
            if live_per_group[self.OVERFLOW] == 0:
                self.e[self.OVERFLOW], self.u[self.OVERFLOW] = 0, 1

    def route_costs(self, rows) -> np.ndarray:
        """int64[len(rows), M]: the cost, less the escape cost, of a task
        of each group in `rows` on each machine."""
        rows = np.asarray(rows, np.int64)
        return (np.minimum(self.e[rows, None], self.pref[rows])
                - self.u[rows, None])


def register_pool(table: Table, scenario: Scenario) -> np.ndarray:
    """Each template's group, registered in pool order (most popular
    first)."""
    return np.array([table.group_for(t) for t in scenario.templates], np.int64)


class Follower:
    """Follows the program's rounds (see the module's docstring). Feed
    it the run's events in order: fill(pu), upkeep(k), round(r, pu);
    each judged round appends its reading to `readings`."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        self.cfg, self.mix = cfg, mix
        self.scenario = Scenario(cfg, seed)
        self.table = Table(cfg, self.scenario)
        self.Tcap = cfg["task_capacity"]
        self.P, self.S = cfg["pus"], cfg["slots"]
        self.num_pus = cfg["machines"] * self.P
        self.live = np.zeros(self.Tcap, bool)
        self.grp = np.zeros(self.Tcap, np.int64)
        self.pu = np.full(self.Tcap, -1, np.int64)
        self.tmpl_gid = register_pool(self.table, self.scenario)
        self.readings = []
        self.control_readings = []

    def _live_per_group(self):
        return np.bincount(self.grp[self.live], minlength=self.table.G)

    def fill(self, pu_after):
        n = self.cfg["tasks"]
        self.live[:n] = True
        self.grp[:n] = self.tmpl_gid[self.scenario.fill_templates]
        window = np.nonzero(self.live & (self.pu < 0))[0]
        self._judge("fill", window, pu_after)

    def upkeep(self, k: int):
        mix = self.mix
        self.table.evict_idle(self._live_per_group(), mix["keep_fraction"])
        self.scenario.refresh(k, mix["refresh_templates"])
        self.tmpl_gid = register_pool(self.table, self.scenario)

    def round(self, r: int, pu_after, control: bool = False):
        mix = self.mix
        done_u, tmpl, offset = self.scenario.round_draws(r, self.Tcap, mix["churn"])
        done = self.live & (self.pu >= 0) & (done_u < np.float32(mix["churn"]))
        self.live &= ~done
        self.pu[done] = -1
        free_rank = np.cumsum(~self.live) - 1
        new = ~self.live & (free_rank < mix["arrivals"])
        self.live |= new
        self.grp[new] = self.tmpl_gid[tmpl[new]]
        self.pu[new] = -1
        window = self._window(np.nonzero(self.live & (self.pu < 0))[0], offset)
        if control:
            _act, supply, free, w = self.instance(window)
            self.control_readings.append(dict(rounds.controls(w, supply, free), round=r))
        self._judge(r, window, pu_after)

    def _window(self, backlog, offset):
        return rounds.window_of(backlog, self.cfg["decode_width"], offset)

    def _judge(self, label, window, pu_after):
        """Judge the program's placements after a round whose decode
        window is `window`, then take them as the state."""
        post = np.asarray(pu_after, np.int64)
        found = rounds.faults(self.pu, post, self.live, window, self.num_pus, self.S)
        gap = None
        if not found:
            act, supply, free, w = self.instance(window)
            y = rounds.new_flow(window, post, self.grp, act, self.cfg["machines"], self.P)
            gap = rounds.gap(w, supply, free, y)
        placed = int((post[window] >= 0).sum()) if post.shape == self.pu.shape else -1
        self.readings.append({"round": label, "gap": gap, "faults": found,
                              "placed": placed})
        self.pu = post.copy()

    def instance(self, window):
        """The round's transport: (active groups, their supply, the
        machines' free slots, the costs w[active, M])."""
        act, supply = np.unique(self.grp[window], return_counts=True)
        placed = self.pu[self.live & (self.pu >= 0)]
        running = np.bincount(placed // self.P, minlength=self.cfg["machines"])
        free = self.P * self.S - running
        return act, supply, free, self.table.route_costs(act)


def judge(cfg: dict, mix: dict, seed: int, events, control=()) -> Follower:
    """Follow a run's events (the system's `events`) and judge every
    round; the rounds in `control` also get the control's reading."""
    follower = Follower(cfg, mix, seed)
    control = set(control)
    for ev in events:
        if ev[0] == "fill":
            follower.fill(ev[1])
        elif ev[0] == "upkeep":
            follower.upkeep(ev[1])
        else:
            follower.round(ev[1], ev[2], control=ev[1] in control)
    return follower


def verdict(cfg: dict, mix: dict, seed: int, events, counts: dict) -> dict:
    """`correct` for a run: every round (the fill, the warm-up and the
    window) judged (rounds.verdict)."""
    return rounds.verdict(judge(cfg, mix, seed, events).readings, counts)
