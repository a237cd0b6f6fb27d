"""What every judged round checks, whatever the cost model.

A round starts from the placements `pre` (a PU a task row, -1 where it
has none), schedules the unplaced rows of its decode window, and the
program reads back `post`. The round is sound when the rows outside the
window kept their placements, every placement is on a PU that exists,
is enabled and has room, and the new placements cost no more than the
optimum of the round's transport (rows: the window's groups, columns:
the machines' free slots).
"""

from __future__ import annotations

import numpy as np

from . import transport


def faults(pre, post, live, window, num_pus, slots, enabled_pu=None) -> list:
    """The ways `post` breaks the round's rules, in words."""
    out = []
    if post.shape != pre.shape:
        return ["placements of the wrong length"]
    in_window = np.zeros(pre.shape[0], bool)
    in_window[window] = True
    moved = ~in_window & (post != pre)
    if moved.any():
        out.append(f"{int(moved.sum())} rows outside the window changed")
    bad = in_window & (post >= num_pus)
    if bad.any():
        out.append(f"{int(bad.sum())} placements on no slot")
    ok = live & (post >= 0) & (post < num_pus)
    per_pu = np.bincount(post[ok], minlength=num_pus)
    if (per_pu > slots).any():
        out.append(f"{int((per_pu > slots).sum())} PUs over capacity")
    if enabled_pu is not None and (per_pu[~enabled_pu] > 0).any():
        out.append(f"{int((per_pu[~enabled_pu] > 0).sum())} disabled PUs in use")
    return out


def new_flow(window, post, group, act, machines: int, pus: int):
    """y[active group, machine]: the window's new placements, by the
    group of each placed row (`group`, a row's group)."""
    placed = window[post[window] >= 0]
    row = np.searchsorted(act, group[placed])
    y = np.zeros((act.shape[0], machines), np.int64)
    np.add.at(y, (row, post[placed] // pus), 1)
    return y


#: negative cycles cancelled in a judged round at most: a flow that has
#: one is not optimal, and the cost of the first CYCLES is its gap's
#: lower bound
CYCLES = 64


def gap(w, supply, free, y) -> int:
    """The cost cancelling negative cycles removes from flow y (at most
    CYCLES of them): 0 when y is optimal, else at least 1."""
    return transport.cancel(w, supply, free, y, max_cycles=CYCLES, partial=True)[1]


def controls(w, supply, free) -> dict:
    """The controls of a round: placements made by the reference in the
    program's place with one guarantee broken, judged like the
    program's. `half_quantum`: the round solved on costs at twice the
    cost quantum (w >> 1), as a program that halved the cost resolution
    to shorten its solves would place; `greedy`: each group in turn to
    its cheapest machines with room, as a program without the solve
    would. Each reading is the gap to the optimum at the configuration's
    quantum."""
    coarse = transport.solve(w >> 1, supply, free)
    return {"half_quantum": gap(w, supply, free, coarse),
            "greedy": gap(w, supply, free, transport.greedy(w, supply, free))}


def window_of(backlog, width: int, offset: int):
    """The decode window: all of the backlog's rows (ascending) when
    they fit, else `width` of them, cyclically from rank offset % n."""
    n = backlog.shape[0]
    if n <= width:
        return backlog
    return backlog[((offset % n) + np.arange(width)) % n]


def verdict(readings, counts) -> dict:
    """`correct` for a run from its judged rounds: each number compared,
    with its limit: the largest gap to the optimum (cost units; 0 where
    every judged round is optimal), the rounds with a fault in their
    placements, and the window's rounds whose `placed` counter differs
    from the placements read back (the last len(counts["placed"])
    rounds are the window's)."""
    window = readings[len(readings) - len(counts["placed"]):]
    miscounted = sum(int(r["placed"] != int(p)) for r, p in zip(window, counts["placed"]))
    gaps = [r["gap"] for r in readings if r["gap"] is not None]
    checks = {"gap_max": {"value": max(gaps, default=0), "limit": 0},
              "faulty_rounds": {"value": sum(bool(r["faults"]) for r in readings), "limit": 0},
              "miscounted_rounds": {"value": miscounted, "limit": 0}}
    failed = sum(bool(r["faults"]) or (r["gap"] or 0) > 0 for r in readings)
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": len(readings), "failed": failed, "checks": checks,
            "faults": [(r["round"], r["faults"]) for r in readings if r["faults"]][:5]}
