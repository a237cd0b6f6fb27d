"""The port's stacked batching (tenancy/batch.py: StackedBatcher,
LaneSolver) against the JAX package's and against each tenant solved
alone by the port's CsrSolver: the batch cases of tests/test_tenancy.py,
tolerance 0 (int32 arithmetic)."""

import numpy as np
import pytest
import torch

from ksched_tpu_torch.graph.device_export import FlowProblem, pad_problem
from ksched_tpu_torch.solver.csr_solver import CsrSolver
from ksched_tpu_torch.tenancy import LaneSolver, StackedBatcher
from torch_tenancy_cells import BUCKETS, ToyCell

jt = pytest.importorskip("ksched_tpu.tenancy")
from ksched_tpu.graph.device_export import FlowProblem as JaxFlowProblem  # noqa: E402


def _batcher():
    return StackedBatcher(device="cpu")


def _lane(batcher, **kw):
    return LaneSolver(batcher, device="cpu", **kw)


def _csr(**kw):
    return CsrSolver(device="cpu", **kw)


def _rows(solver):
    tel = solver.last_telemetry
    return None if tel is None else np.asarray(tel.rows)


@pytest.mark.parametrize("lanes", [2, 4, 16])
def test_stacked_lanes_bit_identical_to_isolated(lanes):
    """2/4/16 tenants over 3 shape buckets through a churn script in
    which lane 0's journal re-wires endpoints every round (the fresh
    restart) while every other lane's is cost-only (the warm refit):
    each lane's flow, objective, supersteps, warm scope and soltel rows
    equal the same tenant solved alone by CsrSolver, and the JAX
    package's LaneSolver on the same cells."""
    def cells():
        return [ToyCell(100 + i, *BUCKETS[i % len(BUCKETS)]) for i in range(lanes)]

    mine, iso_cells, ref_cells = cells(), cells(), cells()
    batcher = _batcher()
    lane_solvers = [_lane(batcher, tenant=f"t{i}", restart_budget=64, telemetry=8)
                    for i in range(lanes)]
    iso = [_csr(restart_budget=64, telemetry=8) for _ in range(lanes)]
    jbatcher = jt.StackedBatcher()
    ref = [jt.LaneSolver(jbatcher, tenant=f"t{i}", restart_budget=64, telemetry=8)
           for i in range(lanes)]
    for r in range(4):
        if r > 0:
            for group in (mine, iso_cells, ref_cells):
                for i, c in enumerate(group):
                    c.churn("endpoint" if i == 0 else "cost")
        pendings = [ls.solve_async(c.problem(FlowProblem))
                    for ls, c in zip(lane_solvers, mine)]
        batcher.flush()
        results = [ls.complete(p) for ls, p in zip(lane_solvers, pendings)]
        jpend = [ls.solve_async(c.problem(JaxFlowProblem)) for ls, c in zip(ref, ref_cells)]
        jbatcher.flush()
        jres = [ls.complete(p) for ls, p in zip(ref, jpend)]
        for i in range(lanes):
            alone = iso[i].solve(iso_cells[i].problem(FlowProblem))
            for want, wsolver in ((alone, iso[i]), (jres[i], ref[i])):
                assert np.array_equal(results[i].flow, want.flow), (r, i)
                assert results[i].objective == want.objective, (r, i)
                assert lane_solvers[i].last_supersteps == wsolver.last_supersteps, (r, i)
                assert lane_solvers[i].last_warm_scope == wsolver.last_warm_scope, (r, i)
                got_rows, want_rows = _rows(lane_solvers[i]), _rows(wsolver)
                assert (got_rows is None) == (want_rows is None)
                if got_rows is not None:
                    assert np.array_equal(got_rows, want_rows), (r, i)
        assert batcher.last_groups == jbatcher.last_groups
        if r > 0:
            assert lane_solvers[0].last_warm_scope == "fresh"
            assert "warm" in {ls.last_warm_scope for ls in lane_solvers}


def test_stacked_one_program_per_bucket_policy():
    """Same-bucket same-policy lanes ride ONE stacked solve: a flush
    runs as many as there are (bucket, policy) groups."""
    batcher = _batcher()
    cells = [ToyCell(7 + i, *BUCKETS[0]) for i in range(5)]
    solvers = [_lane(batcher, tenant=f"t{i}") for i in range(5)]
    pendings = [s.solve_async(c.problem(FlowProblem)) for s, c in zip(solvers, cells)]
    assert batcher.flush() == 1
    assert batcher.last_lanes == 5 and len(batcher.last_supersteps) == 1
    for s, p in zip(solvers, pendings):
        s.complete(p)
    cells2 = [ToyCell(50, *BUCKETS[0]), ToyCell(51, *BUCKETS[1])]
    solvers2 = [_lane(batcher, tenant=f"u{i}") for i in range(2)]
    pend2 = [s.solve_async(c.problem(FlowProblem)) for s, c in zip(solvers2, cells2)]
    assert batcher.flush() == 2
    for s, p in zip(solvers2, pend2):
        s.complete(p)


def test_quarantined_lane_solves_in_its_own_group():
    batcher = _batcher()
    cells = [ToyCell(60 + i, *BUCKETS[0]) for i in range(3)]
    solvers = [_lane(batcher, tenant=f"t{i}") for i in range(3)]
    solvers[1].quarantined = True
    pendings = [s.solve_async(c.problem(FlowProblem)) for s, c in zip(solvers, cells)]
    assert batcher.flush() == 2  # shared group + the solo lane
    flows = [s.complete(p).flow for s, p in zip(solvers, pendings)]
    assert np.array_equal(flows[1], _csr().solve(cells[1].problem(FlowProblem)).flow)


def test_restart_escape_parity_with_isolated():
    """A warm attempt that blows a restart budget of 1 escalates per
    lane (fresh restart, then cost-scaling), attempt for attempt as
    CsrSolver and the JAX package's lane do."""
    cell, iso_cell, ref_cell = (ToyCell(77, *BUCKETS[0]) for _ in range(3))
    lane = _lane(_batcher(), tenant="t0", restart_budget=1)
    iso = _csr(restart_budget=1)
    ref = jt.LaneSolver(jt.StackedBatcher(), tenant="t0", restart_budget=1)
    for r in range(3):
        if r:
            for c in (cell, iso_cell, ref_cell):
                c.churn("cost")
        got = lane.solve(cell.problem(FlowProblem))
        want = iso.solve(iso_cell.problem(FlowProblem))
        jwant = ref.solve(ref_cell.problem(JaxFlowProblem))
        assert np.array_equal(got.flow, want.flow) and np.array_equal(got.flow, jwant.flow), r
        assert lane.last_supersteps == iso.last_supersteps == ref.last_supersteps, r
        assert lane.last_warm_escape == ref.last_warm_escape, r


def test_lane_bucket_floor_pads_and_matches_isolated_padding():
    cell = ToyCell(5, *BUCKETS[0])
    lane = _lane(_batcher(), tenant="t0", bucket_floor=(64, 128))
    got = lane.solve(cell.problem(FlowProblem))
    want = _csr().solve(pad_problem(cell.problem(FlowProblem), 64, 128))
    assert np.array_equal(got.flow, want.flow[: cell.m_cap])
    assert got.objective == want.objective
    jlane = jt.LaneSolver(jt.StackedBatcher(), tenant="t0", bucket_floor=(64, 128))
    jgot = jlane.solve(cell.problem(JaxFlowProblem))
    assert np.array_equal(got.flow, jgot.flow) and lane.last_supersteps == jlane.last_supersteps


def test_pad_problem_rejects_shrink_and_is_inert():
    p = ToyCell(3, *BUCKETS[0]).problem(FlowProblem)
    with pytest.raises(ValueError):
        pad_problem(p, 16, 16)
    q = pad_problem(p, 64, 128)
    assert q.num_nodes == 64 and len(q.src) == 128
    assert (q.cap[p.cap.shape[0]:] == 0).all()
    assert q.num_arcs == p.num_arcs
    assert pad_problem(p, p.num_nodes, len(p.src)) is p


def test_flush_group_failure_degrades_only_that_group():
    """A failed group's lanes raise a degradable RuntimeError at
    complete(); the other group solves and the batcher stays usable."""
    batcher = _batcher()
    cells = [ToyCell(80, *BUCKETS[0]), ToyCell(81, *BUCKETS[1])]
    solvers = [_lane(batcher, tenant=f"t{i}") for i in range(2)]
    pendings = [s.solve_async(c.problem(FlowProblem)) for s, c in zip(solvers, cells)]
    orig = batcher._flush_group

    def flaky(key, reqs):
        if key[0] == BUCKETS[0][0]:
            raise RuntimeError("injected compile failure")
        return orig(key, reqs)

    batcher._flush_group = flaky
    batcher.flush()
    batcher._flush_group = orig
    with pytest.raises(RuntimeError, match="stacked batch dispatch failed"):
        solvers[0].complete(pendings[0])
    res = solvers[1].complete(pendings[1])
    assert np.array_equal(res.flow, _csr().solve(cells[1].problem(FlowProblem)).flow)
    again = solvers[0].solve(cells[0].problem(FlowProblem))
    assert np.array_equal(again.flow, _csr().solve(cells[0].problem(FlowProblem)).flow)


def test_cuda_failure_in_a_group_is_not_degradable():
    """A CUDA runtime failure in a group's stacked solve re-raises as
    itself, which the ladder never absorbs (runtime/degrade.py)."""
    from ksched_tpu_torch.ops.build import KernelError

    batcher = _batcher()
    lane = _lane(batcher, tenant="t0")
    pend = lane.solve_async(ToyCell(82, *BUCKETS[0]).problem(FlowProblem))

    def broken(key, reqs):
        raise KernelError("launch failed")

    batcher._flush_group = broken
    batcher.flush()
    with pytest.raises(KernelError):
        lane.complete(pend)


def test_empty_lane_matches_csr_solver_contract():
    p = FlowProblem(
        num_nodes=16, excess=np.zeros(16, np.int64), node_type=np.zeros(16, np.int8),
        src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32), cap=np.zeros(0, np.int32),
        cost=np.zeros(0, np.int32), flow_offset=np.zeros(0, np.int32), num_arcs=0,
    )
    res = _lane(_batcher(), tenant="t0").solve(p)
    assert res.objective == 0 and len(res.flow) == 0


def test_lane_and_batcher_devices(monkeypatch):
    with pytest.raises(TypeError, match="batcher"):
        LaneSolver(_batcher(), device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (StackedBatcher, lambda: LaneSolver(_batcher())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
