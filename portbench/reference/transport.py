"""Min-cost transport in plain NumPy, by negative cycles.

A transport instance has rows r with supply s[r], columns m with
capacity cap[m] and a cost w[r, m] per unit sent from r to m; a unit
that is not sent escapes at cost 0. A flow y[r, m] is feasible when
every row sends at most its supply and every column takes at most its
capacity, and it is optimal exactly when its residual graph has no cycle
of negative cost. The residual graph has a node per row, a node per
column and the escape node T:

    r -> m  cost  w[r, m], always (a unit moves onto m)
    m -> r  cost -w[r, m], where y[r, m] > 0
    r -> T  cost 0, always (a unit escapes)
    T -> r  cost 0, where row r has escaped units
    m -> T  cost 0, where column m has room
    T -> m  cost 0, where column m is used

`cancel` finds such cycles by Bellman-Ford relaxation of all nodes at
once and sends flow around each until none is left: from a flow another
program produced, the cost it removes is that flow's gap to the optimum
(0 for an optimal flow); from the empty flow, it is a solver.
"""

from __future__ import annotations

import numpy as np

#: a distance larger than any path, small enough that adding a cost
#: cannot overflow int64
_INF = np.int64(1) << 50


class CancelLimit(RuntimeError):
    """Cycle cancelling did not end within its allowance."""


def _relax(w, y, esc, room, used, dist):
    """One synchronous Bellman-Ford pass over the residual graph:
    (candidate distances, their predecessors), -1 where no edge
    improves. Nodes: rows [0, R), columns [R, R + M), T = R + M."""
    R, M = w.shape
    T = R + M
    pred = np.full(T + 1, -1, np.int64)
    new = dist.copy()
    d_r, d_m, d_t = dist[:R], dist[R:T], dist[T]
    # r -> m
    best_r, arg_r = _min_over_rows(d_r[:, None] + w)
    # T -> m where m is used
    best_m = np.where(used > 0, d_t, _INF)
    from_t = best_m < best_r
    cand_m = np.where(from_t, best_m, best_r)
    pm = np.where(from_t, T, arg_r)
    better = cand_m < d_m
    new[R:T] = np.where(better, cand_m, d_m)
    pred[R:T] = np.where(better, pm, -1)
    # m -> r where y[r, m] > 0
    via_m = np.where(y > 0, d_m[None, :] - w, _INF)
    arg_m = via_m.argmin(axis=1)
    best_c = via_m[np.arange(R), arg_m]
    # T -> r where row r has escaped units
    best_t = np.where(esc > 0, d_t, _INF)
    from_t = best_t < best_c
    cand_r = np.where(from_t, best_t, best_c)
    pr = np.where(from_t, T, R + arg_m)
    better = cand_r < d_r
    new[:R] = np.where(better, cand_r, d_r)
    pred[:R] = np.where(better, pr, -1)
    # r -> T, and m -> T where m has room
    cand = [(d_r.min(), int(d_r.argmin())) if R else (_INF, -1)]
    if (room > 0).any():
        d_room = np.where(room > 0, d_m, _INF)
        cand.append((d_room.min(), R + int(d_room.argmin())))
    c_t, p_t = min(cand)
    if c_t < d_t:
        new[T] = c_t
        pred[T] = p_t
    return new, pred


def _min_over_rows(a):
    """(min, argmin) over axis 0, the first row winning ties."""
    if a.shape[0] > 8:
        arg = a.argmin(axis=0)
        return a[arg, np.arange(a.shape[1])], arg
    best, arg = a[0].copy(), np.zeros(a.shape[1], np.int64)
    for r in range(1, a.shape[0]):
        better = a[r] < best
        best = np.where(better, a[r], best)
        arg = np.where(better, r, arg)
    return best, arg


def _find_cycle(pred):
    """A cycle of the predecessor graph as a list of nodes in flow
    order, or None. Following pred from any node n times (by pointer
    doubling) ends on a cycle unless the chain ends first."""
    n = pred.shape[0]
    jump = np.where(pred >= 0, pred, n)
    jump = np.append(jump, n)  # node n: where chains end
    steps = 1
    while steps < n:
        jump = jump[jump]
        steps *= 2
    on_cycle = jump[:n][jump[:n] < n]
    if on_cycle.size == 0:
        return None
    v = int(on_cycle[0])
    cycle, u = [v], int(pred[v])
    while u != v:
        cycle.append(u)
        u = int(pred[u])
    return cycle[::-1]


def cancel(w, supply, cap, y=None, max_cycles: int = 1 << 14, partial: bool = False):
    """Cancel the negative cycles of flow `y` (the empty flow when None)
    on the instance (w int[R, M], supply int[R], cap int[M]). Returns
    (the optimal flow reached, the cost removed). Raises ValueError if
    `y` is not feasible. Past `max_cycles` cycles it raises CancelLimit,
    or with `partial` returns (the flow so far, the cost removed so
    far): then the gap is at least that cost."""
    w = np.asarray(w, np.int64)
    R, M = w.shape
    supply = np.asarray(supply, np.int64)
    cap = np.asarray(cap, np.int64)
    y = np.zeros((R, M), np.int64) if y is None else np.array(y, np.int64)
    if y.shape != (R, M) or (y < 0).any():
        raise ValueError("flow must be non-negative of the instance's shape")
    esc = supply - y.sum(axis=1)
    used = y.sum(axis=0)
    if (esc < 0).any() or (used > cap).any():
        raise ValueError("flow exceeds a supply or a capacity")
    T = R + M
    removed = 0
    for _ in range(max_cycles):
        dist = np.zeros(T + 1, np.int64)
        preds = np.full(T + 1, -1, np.int64)
        cycle = None
        for it in range(1, 64 * (T + 1)):
            new, pred = _relax(w, y, esc, cap - used, used, dist)
            moved = pred >= 0
            if not moved.any():
                break
            dist = new
            preds = np.where(moved, pred, preds)
            # a simple path visits each row once, so without a negative
            # cycle the distances settle within 2R + 4 passes
            if it > 2 * R + 4:
                cycle = _find_cycle(preds)
                if cycle is not None:
                    break
        else:
            raise CancelLimit("Bellman-Ford did not settle")
        if cycle is None:
            return y, removed
        removed += _push(cycle, w, y, esc, cap, used, R, T)
    if partial:
        return y, removed
    raise CancelLimit(f"more than {max_cycles} negative cycles")


def _push(cycle, w, y, esc, cap, used, R, T):
    """Send the bottleneck amount around `cycle` (nodes in flow order),
    updating y, esc and used in place. Returns the cost removed."""
    edges = list(zip(cycle, cycle[1:] + cycle[:1]))
    cost, room = 0, None

    def limit(x):
        return x if room is None else min(room, x)

    for a, b in edges:
        if a < R and R <= b < T:  # r -> m
            cost += int(w[a, b - R])
        elif R <= a < T and b < R:  # m -> r
            cost -= int(w[b, a - R])
            room = limit(int(y[b, a - R]))
        elif a < R and b == T:  # r -> T
            pass
        elif a == T and b < R:  # T -> r
            room = limit(int(esc[b]))
        elif R <= a < T and b == T:  # m -> T
            room = limit(int(cap[a - R] - used[a - R]))
        elif a == T and R <= b < T:  # T -> m
            room = limit(int(used[b - R]))
        else:
            raise AssertionError(f"no residual edge {a} -> {b}")
    if cost >= 0 or not room:
        raise AssertionError(f"cycle of cost {cost} and room {room}")
    for a, b in edges:
        if a < R and R <= b < T:
            y[a, b - R] += room
            used[b - R] += room
        elif R <= a < T and b < R:
            y[b, a - R] -= room
            used[a - R] -= room
        elif a < R and b == T:
            esc[a] += room
        elif a == T and b < R:
            esc[b] -= room
    return -cost * room


def greedy(w, supply, cap):
    """Each row in turn sends its units to its cheapest columns with
    room, while sending costs less than escaping: a feasible flow, not
    an optimal one."""
    w = np.asarray(w, np.int64)
    room = np.array(cap, np.int64)
    y = np.zeros(w.shape, np.int64)
    for r in range(w.shape[0]):
        left = int(supply[r])
        for m in np.argsort(w[r], kind="stable"):
            if left == 0 or w[r, m] >= 0:
                break
            take = min(left, int(room[m]))
            y[r, m] += take
            room[m] -= take
            left -= take
    return y


def solve(w, supply, cap):
    """An optimal flow: the greedy flow with its negative cycles
    cancelled."""
    return cancel(w, supply, cap, greedy(w, supply, cap))[0]


def cost_of(w, y) -> int:
    """The cost of flow y: escaped units cost 0."""
    return int((np.asarray(w, np.int64) * np.asarray(y, np.int64)).sum())
