"""The device-resident mirror (ksched_tpu_torch/graph/device_export.py
DeviceResidentState, on the CPU) against the JAX package's, bit for bit
(tolerance 0): per round the packed delta and plan records, the upload
and plan kinds, the bytes and record counts, and the flows of CsrSolver
beside JaxSolver; the mirror's parity checks; the device warm flow
against the host mask (cf. tests/test_pipeline.py:236); resident
FlowScheduler rounds against host rounds (cf. tests/test_pipeline.py:142);
and the aliasing rule of the delta apply: src and dst get new tensors
(the solver's last-solve endpoints must survive a refresh), excess, cap
and cost are updated in place."""

import numpy as np
import pytest
import torch

from ksched_tpu.graph.device_export import device_warm_flow_fn
from ksched_tpu_torch.drivers import add_job, add_task_to_job, build_cluster
from ksched_tpu_torch.graph.device_export import device_warm_flow
from ksched_tpu_torch.solver.csr_solver import CsrSolver
from ksched_tpu_torch.utils import seed_rng

from torch_plan_twin import SCRIPT, Pair, churn_round


@pytest.mark.parametrize("nt,nm", [(8, 3), (24, 5)])
def test_records_bytes_and_flows_match_jax(nt, nm):
    pair = Pair(nt, nm, machine_cap=(nt, nt + 4))
    rng = np.random.default_rng(7)
    pair.solve_round("round 0")
    kinds = {pair.tres.last_plan_kind}
    for rnd, kind in enumerate(SCRIPT, 1):
        churn_round(pair, kind, rng)
        pair.solve_round(f"round {rnd} ({kind})")
        kinds.add(pair.tres.last_plan_kind)
        assert pair.tres.last_upload_kind == "delta"
    assert kinds == {"none", "rebuild", "delta", "clean"}


def test_parity_checks_catch_a_diverged_mirror():
    pair = Pair(8, 3)
    pair.solve_round("round 0")
    pair.solve_round("round 1")
    res = pair.tres
    res.d_cap[3] += 1
    with pytest.raises(AssertionError, match="device mirror cap"):
        res.parity_check()
    res.d_cap[3] -= 1
    res.parity_check()
    live = int(np.flatnonzero(pair.t.plan.p_sign)[0])
    res.d_p_sign[live] = 0
    with pytest.raises(AssertionError, match="device plan mirror p_sign"):
        res.plan_parity_check()


def test_device_warm_flow_matches_host_mask_and_jax():
    rng = np.random.default_rng(0)
    m = 64
    src0 = rng.integers(1, 9, m).astype(np.int32)
    dst0 = rng.integers(1, 9, m).astype(np.int32)
    src1, dst1 = src0.copy(), dst0.copy()
    moved = rng.random(m) < 0.3
    src1[moved] = rng.integers(1, 9, int(moved.sum())).astype(np.int32)
    prev = rng.integers(0, 10, m).astype(np.int32)
    cap = rng.integers(0, 6, m).astype(np.int32)
    got = device_warm_flow(*(torch.as_tensor(x) for x in (prev, src0, dst0, src1,
                                                          dst1, cap))).numpy()
    same = (src0 == src1) & (dst0 == dst1)
    want = np.where(same, np.minimum(prev, cap), 0).astype(np.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(device_warm_flow_fn()(prev, src0, dst0, src1, dst1, cap)))


def _churn_rounds(resident, rounds=6):
    """tests/test_pipeline.py's scenario on this package: 10 tasks on 4
    machines x 2 PUs x 2 slots, 3 of them completed and 3 added a
    round; the bindings by task name per round."""
    seed_rng(7)
    sched, _r, jmap, tmap, _root = build_cluster(
        num_machines=4, num_cores=1, pus_per_core=2, max_tasks_per_pu=2,
        backend=CsrSolver(device="cpu"), device_resident=resident,
    )
    job_id = add_job(sched, jmap, tmap, num_tasks=10)
    sched.schedule_all_jobs()
    rng = np.random.default_rng(42)
    hist = []
    for _ in range(rounds):
        bound = sorted(sched.task_bindings.items())
        for i in sorted((int(x) for x in rng.choice(len(bound), 3, replace=False)),
                        reverse=True):
            sched.handle_task_completion(tmap.find(bound[i][0]))
        for _ in range(3):
            add_task_to_job(job_id, jmap, tmap)
        sched.add_job(jmap.find(job_id))
        sched.schedule_all_jobs()
        hist.append(sorted((tmap.find(t).name, r) for t, r in sched.task_bindings.items()))
        if resident:
            sched.solver.resident.parity_check()
            sched.solver.resident.plan_parity_check()
            assert sched.solver.resident.last_upload_kind == "delta"
    return hist, sched


def test_resident_rounds_match_host_rounds():
    host, _ = _churn_rounds(False)
    resident, sched = _churn_rounds(True)
    assert resident == host
    assert sched.solver.backend._prev_dev is not None  # warm state on the device


def _rewire(pair, t):
    """Move task t's first machine arc to a machine it has no arc to
    (the freed slot is re-used by the new arc: an endpoint change)."""
    s, d = next((s, d) for s, d in pair.live() if s == t and d in pair.machines)
    m = next(m for m in pair.machines if (t, m) not in pair.t._arc_slot)
    pair.kill(s, d)
    pair.arc(t, m, 1, 3)


def test_delta_apply_keeps_pre_delta_endpoints():
    """A rewire round's refresh leaves the endpoint tensors the solver
    captured at its last solve untouched (src/dst get new tensors),
    while excess, cap and cost are updated in place, as the JAX package
    donates them. An in-place endpoint update would rewrite the solver's
    last-solve endpoints and pass every arc through its warm mask."""
    pair = Pair(24, 5, machine_cap=(24, 28))
    pair.solve_round("round 0")
    res = pair.tres
    ptrs = [t.data_ptr() for t in (res.d_excess, res.d_cap, res.d_cost)]
    for rnd, t in enumerate(pair.tasks[:3]):
        held_src, held_dst = pair.ts._prev_src_dev, pair.ts._prev_dst_dev
        assert held_src is res.d_src and held_dst is res.d_dst
        before = held_src.clone(), held_dst.clone()
        _rewire(pair, t)
        jp, tp = pair.problems(check_records=False)
        assert torch.equal(held_src, before[0]) and torch.equal(held_dst, before[1]), (
            f"round {rnd}: the refresh rewrote the last solve's endpoints")
        assert not torch.equal(res.d_dst, held_dst)
        assert [t.data_ptr() for t in (res.d_excess, res.d_cap, res.d_cost)] == ptrs
        res.parity_check()
        tr, jr = pair.ts.solve(tp), pair.js.solve(jp)
        np.testing.assert_array_equal(tr.flow, jr.flow)
        assert pair.ts.last_supersteps == pair.js.last_supersteps


def test_resident_state_on_cuda_needs_a_card():
    from ksched_tpu_torch.graph.device_export import DeviceGraphState, DeviceResidentState

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        DeviceResidentState(DeviceGraphState())
