"""The port's stability-aware and three-tier preemption against the JAX
package's, bit for bit, on the CPU: the hybrid round's tier choice
(incremental, scoped, global), escalation of a budgeted incremental
attempt, census drift and realized cost — tests/test_preemption_device.py's
hybrid, scoped, three-tier and budget tests at their own shapes (40
machines x 4 PUs x 4 slots, CoCo over 4 classes, continuation discount
8, a 256-row decode window). Each package runs its own
`run_steady_rounds(seed)`: the port's makes the JAX package's draws
(utils/threefry.py). Tolerance 0: every stat, and the state, equal with
its dtype."""

import numpy as np
import pytest

from ksched_tpu.costmodels import coco
from ksched_tpu.costmodels.device_costs import coco_device_cost_fn as jax_coco
from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster as JaxCluster
from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster
from ksched_tpu_torch.solver.layered import read_branch, read_flag

M = 40


def _pair(T=400, seed=7, **over):
    """(JAX cluster, port cluster) of tests/test_preemption_device.py's
    `_tri_cluster` shape, filled with T tasks and one round."""
    rng = np.random.default_rng(seed)
    pen = rng.integers(0, 40, (M, 4)).astype(np.int64)
    kw = dict(
        num_machines=M, pus_per_machine=4, slots_per_pu=4, num_jobs=4,
        num_task_classes=4, task_capacity=1024,
        unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0,
        supersteps=1 << 16, preemption=True, continuation_discount=8,
        decode_width=256, track_realized_cost=True,
    )
    kw.update(over)
    jc = JaxCluster(class_cost_fn=jax_coco(pen), **kw)
    tc = DeviceBulkCluster(class_cost_fn=coco_device_cost_fn(pen), device="cpu", **kw)
    jobs = rng.integers(0, 4, T).astype(np.int32)
    classes = rng.integers(0, 4, T).astype(np.int32)
    for c in (jc, tc):
        c.add_tasks(T, jobs, classes)
    _same_stats(jc.fetch_stats(jc.round()), tc.fetch_stats(tc.round()))
    return jc, tc


def _same_stats(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert y.dtype == x.dtype, (k, y.dtype, x.dtype)
        np.testing.assert_array_equal(y, x, err_msg=k)


def _same_state(jc, tc):
    js, ts = jc.fetch_state(), tc.fetch_state()
    for k in js:
        assert ts[k].dtype == np.asarray(js[k]).dtype, k
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)
    np.testing.assert_array_equal(tc._hyb_census.numpy(), np.asarray(jc._hyb_census))
    assert (tc._hyb_k, tc._hyb_kg) == (int(jc._hyb_k), int(jc._hyb_kg))


def _steady(jc, tc, rounds, churn, arrivals, seed):
    a = jc.fetch_stats(jc.run_steady_rounds(rounds, churn, arrivals, seed=seed))
    b = tc.fetch_stats(tc.run_steady_rounds(rounds, churn, arrivals, seed=seed))
    _same_stats(a, b)
    _same_state(jc, tc)
    return b


@pytest.mark.parametrize("every,drift", [(8, 0), (1 << 20, 60), (1, 1 << 30)],
                         ids=["cadence", "drift-trigger", "every-round"])
def test_hybrid_schedule_and_drift_trigger_match(every, drift):
    """tests/test_preemption_device.py:363 and :400: the two-tier
    hybrid on cadence, on the drift trigger alone, and re-solving every
    round (the realized-cost baseline) — every round's tier, drift and
    realized cost equal; one branch read a round where the drift
    trigger is on."""
    jc, tc = _pair(preempt_every=every, preempt_drift=drift)
    reads = read_branch.count
    s = _steady(jc, tc, 32, 0.05, 20, seed=3)
    assert read_branch.count - reads == (32 if drift else 0)
    assert s["converged"].all()
    full = s["full_round"]
    if every == 8:
        assert np.nonzero(full)[0].tolist() == [7, 15, 23, 31]
        assert (s["migrated"][~full] == 0).all() and (s["preempted"][~full] == 0).all()
    if every == 1 << 20:
        assert 0 < full[1:].sum() < 31
        fired = np.nonzero(full)[0]
        assert (s["census_drift"][fired[fired > 0]] >= 60).all()


def test_scoped_preemption_pins_out_of_scope_residents():
    """tests/test_preemption_device.py:531 (there through a replay
    round): completions on one machine make it the whole scope of the
    cadence-fired scoped round — residents move only off that machine,
    in both packages alike."""
    jc, tc = _pair(T=600, preempt_every=2, preempt_global_every=1000)
    st0 = tc.fetch_state()
    on = st0["live"] & (st0["pu"] >= 0)
    m_of = np.clip(st0["pu"], 0, tc.num_pus - 1) // tc.P
    m_star = int(np.argmax(np.bincount(m_of[on], minlength=M)))
    victims = np.nonzero(on & (m_of == m_star))[0][:3]
    for c in (jc, tc):
        c.complete_tasks(victims.astype(np.int32))
    s = _steady(jc, tc, 2, 0.0, 0, seed=5)
    assert s["full_round"].tolist() == [False, True]
    assert s["global_round"].tolist() == [False, False]
    st1 = tc.fetch_state()
    moved = st0["live"] & st1["live"] & (st0["pu"] >= 0) & (st1["pu"] != st0["pu"])
    assert (m_of[moved] == m_star).all()


@pytest.mark.parametrize("every,global_every,rounds", [(4, 16, 32), (8, 32, 48)])
def test_three_tier_global_cadence_matches(every, global_every, rounds):
    """tests/test_preemption_device.py:584: scoped rounds on cadence,
    global rounds on their rarer one, realized cost round for round."""
    jc, tc = _pair(preempt_every=every, preempt_global_every=global_every)
    s = _steady(jc, tc, rounds, 0.05, 20, seed=5)
    full, glob = s["full_round"], s["global_round"]
    assert np.nonzero(full)[0].tolist() == list(range(every - 1, rounds, every))
    assert np.nonzero(glob)[0].tolist() == list(range(global_every - 1, rounds,
                                                      global_every))


def test_incr_budget_escalates_to_scoped_parity():
    """tests/test_preemption_device.py:697: with a 1-superstep budget
    every incremental attempt fails and escalates to the scoped tier;
    the end state equals a twin whose drift trigger fires the scoped
    tier directly — and each equals the JAX package's."""
    a = _pair(T=600, preempt_every=1000, preempt_global_every=1000,
              preempt_incr_budget=1)
    b = _pair(T=600, preempt_every=1000, preempt_drift=1,
              preempt_global_every=1000)
    sa = _steady(*a, 6, 0.05, 12, seed=5)
    sb = _steady(*b, 6, 0.05, 12, seed=5)
    assert sa["escalated_round"].all() and sb["full_round"].all()
    assert sa["full_round"].all() and sa["converged"].all()
    ta, tb = a[1].fetch_state(), b[1].fetch_state()
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_incr_budget_none_and_branch_reads():
    """tests/test_preemption_device.py:749: the three-tier scheme with
    and without an unused budget gives the same rounds; host reads are
    one per solve attempt plus one per round's drift test."""
    jc, tc = _pair(preempt_every=4, preempt_drift=10_000, preempt_global_every=16)
    flags, branches = read_flag.count, read_branch.count
    s = _steady(jc, tc, 8, 0.05, 10, seed=3)
    assert not s["escalated_round"].any()
    assert read_branch.count - branches == 8
    assert read_flag.count - flags == 8  # one attempt a round, no retry
    jb, tb = _pair(preempt_every=4, preempt_drift=10_000, preempt_global_every=16,
                   preempt_incr_budget=1 << 16)
    sb = _steady(jb, tb, 8, 0.05, 10, seed=3)
    for k in ("placed", "supersteps", "full_round", "global_round", "realized_cost"):
        np.testing.assert_array_equal(sb[k], s[k], err_msg=k)


@pytest.mark.parametrize("over,err", [
    (dict(preempt_scope_tau=0), ValueError),
    (dict(preempt_global_every=4), ValueError),  # needs the hybrid scheme
    (dict(preempt_every=2, preempt_incr_budget=8), ValueError),  # needs 3 tiers
    (dict(preempt_every=2, preempt_global_every=4, preempt_incr_budget=0), ValueError),
    (dict(num_groups=4, job_unsched_cost=[1, 2, 3, 4]), ValueError),
    (dict(num_groups=4, active_groups_cap=(0, 2)), ValueError),
    (dict(num_groups=4, two_stage_eps0="half"), ValueError),
], ids=["tau", "global-alone", "budget-two-tier", "budget-0", "groups-per-job",
        "cap-0", "eps0-name"])
def test_validation_matches(over, err):
    """The constructor refuses what the JAX package's refuses."""
    kw = dict(num_machines=4, pus_per_machine=1, slots_per_pu=1, num_jobs=4,
              task_capacity=16, preemption=True)
    kw.update(over)
    with pytest.raises(err):
        JaxCluster(**kw)
    with pytest.raises(err):
        DeviceBulkCluster(device="cpu", **kw)
