"""Batched what-if solves (ksched_tpu_torch/parallel/whatif.py) against
the JAX package's (ksched_tpu/parallel/whatif.py) on the CPU: the four
cases of tests/test_whatif.py through both packages, y, objectives,
unscheduled counts and converged flags equal (tolerance 0), each
package's own assertions kept; and the seeded what-if batches of the
smoke's phase at a test size."""

import numpy as np
import pytest

from ksched_tpu.parallel import whatif as jw
from ksched_tpu.scheduler.bulk import BulkCluster as JBulk
from ksched_tpu.solver.layered import LayeredProblem as JLP
from ksched_tpu.solver.layered import LayeredTransportSolver as JLayered

from ksched_tpu_torch.parallel import whatif as tw
from ksched_tpu_torch.scheduler.bulk import BulkCluster as TBulk
from ksched_tpu_torch.solver.layered import LayeredProblem as TLP
from ksched_tpu_torch.solver.layered import LayeredTransportSolver as TLayered


def _assert_same(t, j):
    np.testing.assert_array_equal(t.y, j.y)
    np.testing.assert_array_equal(t.objective, j.objective)
    np.testing.assert_array_equal(t.num_unsched, j.num_unsched)
    np.testing.assert_array_equal(t.converged, j.converged)
    assert t.y.dtype == j.y.dtype == np.int64


@pytest.mark.parametrize("C", [1, 3])
def test_batch_matches_sequential(C):
    rng = np.random.default_rng(0)
    M, K = 20, 6
    cost_cm = rng.integers(0, 15, (K, C, M)).astype(np.int64)
    supply = rng.integers(0, 50, (K, C)).astype(np.int64)
    col_cap = rng.integers(0, 8, (K, M)).astype(np.int64)
    tsolver = tw.WhatIfSolver(M, C, unsched_cost=25, ec_cost=2, device="cpu")
    batch = tsolver.solve_batch(cost_cm, supply, col_cap)
    jbatch = jw.WhatIfSolver(M, C, unsched_cost=25, ec_cost=2).solve_batch(
        cost_cm, supply, col_cap)
    _assert_same(batch, jbatch)
    assert batch.converged.all()
    for k in range(K):
        fields = dict(supply=supply[k].astype(np.int32), col_cap=col_cap[k].astype(np.int32),
                      cost_cm=cost_cm[k].astype(np.int32), unsched_cost=25, ec_cost=2)
        res = TLayered(device="cpu").solve_layered(TLP(**fields))
        jres = JLayered().solve_layered(JLP(**fields))
        assert batch.objective[k] == res.objective == jres.objective, f"scenario {k}"
        assert batch.num_unsched[k] == res.num_unsched
    assert tsolver.last_supersteps.shape == (K,)
    if C == 1:
        assert (tsolver.last_supersteps == 0).all()  # the closed form


def _cluster(pkg, C=2, M=6, seed=3):
    """tests/test_whatif.py's `_cluster` in either package."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 10, (C, M)).astype(np.int32)
    Bulk, Layered = (TBulk, lambda: TLayered(device="cpu")) if pkg == "t" else (JBulk, JLayered)
    cluster = Bulk(
        num_machines=M, pus_per_machine=2, slots_per_pu=2, num_jobs=3,
        backend=Layered(), task_capacity=256, num_task_classes=C,
        class_cost_fn=lambda cl: cost, unsched_cost=25,
    )
    n = 20
    cluster.add_tasks(n, rng.integers(0, 3, n).astype(np.int32),
                      rng.integers(0, C, n).astype(np.int32))
    cluster.round()
    return cluster


def test_drain_scenarios_cover_displaced_tasks():
    cluster, jcluster = _cluster("t"), _cluster("j")
    res = tw.drain_scenarios(cluster, np.arange(cluster.M), device="cpu")
    _assert_same(res, jw.drain_scenarios(jcluster, np.arange(jcluster.M)))
    assert res.converged.all()
    for k in range(cluster.M):
        assert res.y[k, :, k].sum() == 0
    placed_machine = np.where(
        cluster.task_live & (cluster.task_pu >= 0), cluster.task_pu // cluster.P, -1
    )
    backlog = int((cluster.task_live & (cluster.task_pu < 0)).sum())
    for k in range(cluster.M):
        displaced = int((placed_machine == k).sum())
        assert res.y[k].sum() + res.num_unsched[k] == backlog + displaced


def test_degenerate_batch_and_index_guard():
    cost = np.zeros((3, 8), np.int64)
    args = (cost, np.full((4, 3), 7, np.int64), np.full((4, 8), 2, np.int64))
    res = tw.WhatIfSolver(8, 3, unsched_cost=25, ec_cost=2, device="cpu").solve_batch(*args)
    _assert_same(res, jw.WhatIfSolver(8, 3, unsched_cost=25, ec_cost=2).solve_batch(*args))
    assert res.converged.all()
    assert (res.num_unsched == 5).all()  # 21 supply into 16 slots

    cluster = _cluster("t")
    with pytest.raises(IndexError):
        tw.drain_scenarios(cluster, [-1], device="cpu")
    with pytest.raises(IndexError):
        tw.drain_scenarios(cluster, [cluster.M], device="cpu")


def test_surge_scenarios_monotone_unsched():
    cluster, jcluster = _cluster("t"), _cluster("j")
    surges = np.stack([np.full(cluster.C, s) for s in (0, 5, 50, 500)])
    res = tw.surge_scenarios(cluster, surges, device="cpu")
    _assert_same(res, jw.surge_scenarios(jcluster, surges))
    assert res.converged.all()
    assert (np.diff(res.num_unsched) >= 0).all()


def test_seeded_batches_of_the_smoke_at_a_test_size():
    """drivers/parallel_scenarios.py's cluster and what-if inputs (the
    smoke's phase, cut to 60 machines and 600 tasks), both packages."""
    from ksched_tpu_torch.drivers.parallel_scenarios import (
        LAYERED,
        WHATIF,
        layered_cluster,
        round_record,
        whatif_inputs,
    )

    size = dict(LAYERED, machines=60, tasks=600)
    tc = layered_cluster(TBulk, TLayered(device="cpu"), **size)
    jc = layered_cluster(JBulk, JLayered(), **size)
    assert round_record(tc, tc.round()) == round_record(jc, jc.round())
    machines, surge = whatif_inputs(tc, **WHATIF)
    _assert_same(tw.drain_scenarios(tc, machines, device="cpu"),
                 jw.drain_scenarios(jc, machines))
    _assert_same(tw.surge_scenarios(tc, surge, device="cpu"),
                 jw.surge_scenarios(jc, surge))


def test_whatif_refuses_the_card_where_there_is_none():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.WhatIfSolver(8, 2, unsched_cost=25, ec_cost=2)
