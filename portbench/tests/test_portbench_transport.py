"""The reference's transport: its optimum against a linear program, and
the gap it reads from a flow that is not optimal."""

import numpy as np
import pytest
from scipy.optimize import linprog

from portbench.reference import transport


def _instance(seed):
    rng = np.random.default_rng(seed)
    R, M = rng.integers(1, 6), rng.integers(1, 8)
    w = rng.integers(-30, 5, (R, M))
    return w, rng.integers(0, 9, R), rng.integers(0, 6, M)


def _lp_optimum(w, supply, cap):
    R, M = w.shape
    a_rows = np.kron(np.eye(R), np.ones(M))
    a_cols = np.kron(np.ones(R), np.eye(M))
    res = linprog(w.ravel(), A_ub=np.vstack([a_rows, a_cols]),
                  b_ub=np.concatenate([supply, cap]), bounds=(0, None), method="highs")
    return round(res.fun)


@pytest.mark.parametrize("seed", range(40))
def test_solve_reaches_the_optimum(seed):
    w, supply, cap = _instance(seed)
    y = transport.solve(w, supply, cap)
    assert (y.sum(axis=1) <= supply).all() and (y.sum(axis=0) <= cap).all()
    assert transport.cost_of(w, y) == _lp_optimum(w, supply, cap)
    assert transport.cancel(w, supply, cap, y)[1] == 0


@pytest.mark.parametrize("seed", range(20))
def test_gap_of_a_flow_is_its_distance_to_the_optimum(seed):
    w, supply, cap = _instance(seed)
    y = transport.greedy(w, supply, cap)
    best = _lp_optimum(w, supply, cap)
    assert transport.cancel(w, supply, cap, y)[1] == transport.cost_of(w, y) - best


def test_an_infeasible_flow_is_refused():
    w = np.array([[-3, -1]])
    with pytest.raises(ValueError):
        transport.cancel(w, [1], [1, 1], np.array([[2, 0]]))
