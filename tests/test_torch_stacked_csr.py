"""The port's stacked lane solve (solver/csr_solver.py `stacked_solve_fn`)
against the JAX package's `stacked_solve_fn` (jit(vmap(_solve_mcmf)))
and against each lane solved alone by the port's `_solve_mcmf`:
flows, potentials, supersteps, convergence, the overflow flag and the
soltel rings, with tolerance 0 (int32 arithmetic)."""

import numpy as np
import pytest
import torch

from ksched_tpu_torch.solver import csr_solver as tcs
from torch_tenancy_cells import BUCKETS, ToyCell, lane_inputs

jax_solver = pytest.importorskip("ksched_tpu.solver.jax_solver")


def _stack(lanes):
    """[L, ...] numpy columns: cap, cost, supply, flow0, then the plan."""
    cols = [np.stack([ln[i] for ln in lanes]) for i in range(4)]
    plan = [np.stack([ln[4][i] for ln in lanes]) for i in range(10)]
    return cols, plan


def _run_both(lanes, eps, warm_p=None, **statics):
    import jax.numpy as jnp

    cols, plan = _stack(lanes)
    head = cols + [np.asarray(eps, np.int32)]
    if warm_p is not None:
        head.append(warm_p)
    use_warm = warm_p is not None
    want = jax_solver.stacked_solve_fn(use_warm_p=use_warm, **statics)(
        *(jnp.asarray(a) for a in head + plan))
    tcs._solve_stacked.reads = 0
    got = tcs.stacked_solve_fn(use_warm_p=use_warm, **statics)(
        *(torch.as_tensor(a) for a in head + plan))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _alone(lane, eps, warm_p=None, **statics):
    cap, cost, supply, flow0, plan = lane
    out = tcs._solve_mcmf(
        *(torch.as_tensor(a) for a in (cap, cost, supply, flow0)), int(eps),
        *(torch.as_tensor(a) for a in plan),
        warm_p=None if warm_p is None else torch.as_tensor(warm_p),
        use_warm_p=warm_p is not None, **statics)
    return [o.numpy() for o in out]


def _assert_equal(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, k)


@pytest.mark.parametrize("tel", [0, 8])
@pytest.mark.parametrize("warm", [False, True])
def test_stacked_equals_jax_and_each_lane_alone(tel, warm):
    """Four lanes of one bucket (mixed sizes padded up to it), one with a
    warm random start, one cold at eps = max|cost|·n: each lane takes its
    own superstep count, and the stack equals the JAX package's output
    and every lane solved alone."""
    n_cap, m_cap = 128, 256
    rng = np.random.default_rng(7)
    cells = [ToyCell(30 + i, n_cap, m_cap, *BUCKETS[i % 3][2:]) for i in range(4)]
    lanes = [lane_inputs(c, tcs.build_csr_plan, rng if i == 1 else None)
             for i, c in enumerate(cells)]
    eps = [1, 1, int(np.abs(lanes[2][1]).max()), 1]
    warm_p = None
    if warm:
        warm_p = rng.integers(-4000, 4000, (4, n_cap)).astype(np.int32)
    statics = dict(alpha=8, max_supersteps=4096, tighten_sweeps=32, telemetry_cap=tel)
    want, got = _run_both(lanes, eps, warm_p, **statics)
    _assert_equal(got, want, "stack vs jax")
    assert len(set(got[2].tolist())) > 1  # the lanes froze at their own counts
    for i, lane in enumerate(lanes):
        alone = _alone(lane, eps[i], None if warm_p is None else warm_p[i], **statics)
        _assert_equal([g[i] for g in got], alone, f"lane {i} vs alone")
    assert tcs._solve_stacked.reads >= int(got[2].max())


def test_spent_lane_freezes_without_lengthening_the_others():
    """A lane cold-started at a large eps with a tiny budget freezes
    unconverged at the budget; the other lanes keep their own counts."""
    cells = [ToyCell(60 + i, *BUCKETS[1]) for i in range(3)]
    lanes = [lane_inputs(c, tcs.build_csr_plan) for c in cells]
    eps = [1, int(np.abs(lanes[1][1]).max()), 1]
    statics = dict(alpha=8, max_supersteps=12, tighten_sweeps=32, telemetry_cap=4)
    want, got = _run_both(lanes, eps, **statics)
    _assert_equal(got, want, "stack vs jax")
    assert got[2][1] == 12 and not got[3][1]
    for i in (0, 2):
        alone = _alone(lanes[i], eps[i], **statics)
        _assert_equal([g[i] for g in got], alone, f"lane {i} vs alone")
        assert got[3][i] and got[2][i] < 12


def test_lane_values_do_not_depend_on_their_neighbours():
    """int32 prefix sums run along each lane's own entry axis: a lane
    whose excess and capacities sit near 2**30 beside a small lane gives
    each the values it gives alone (a flat [L*E] cumsum would carry the
    big lane's sums into the small one's and wrap)."""
    big = ToyCell(5, *BUCKETS[0])
    big.excess[1 : 1 + big.tasks] = (1 << 30) // 8
    big.excess[big.sink] = -int(big.excess[1 : 1 + big.tasks].sum())
    big.cap[: big.k] = (1 << 30) - 1
    small = ToyCell(6, *BUCKETS[0])
    lanes = [lane_inputs(c, tcs.build_csr_plan) for c in (big, small, big, small)]
    statics = dict(alpha=8, max_supersteps=64, tighten_sweeps=32, telemetry_cap=8)
    want, got = _run_both(lanes, [1] * 4, **statics)
    _assert_equal(got, want, "stack vs jax")
    for i, lane in enumerate(lanes):
        _assert_equal([g[i] for g in got], _alone(lane, 1, **statics), f"lane {i}")
    _w, pair = _run_both(lanes[1:2] * 2, [1, 1], **statics)
    _assert_equal([g[1] for g in got], [g[0] for g in pair], "small lane beside itself")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 9, 16, 17])
def test_pad_lane_count(k):
    assert tcs.pad_lane_count(k) == jax_solver.pad_lane_count(k)
    assert tcs.MIN_LANE_BUCKET == jax_solver.MIN_LANE_BUCKET
