"""Quincy group mode in the port against the JAX package, bit for bit,
on the CPU: the port's QuincyGroupTable (costmodels/quincy_device.py)
against the JAX package's under the same registrations, evictions and
aging, and the port's grouped DeviceBulkCluster against the JAX
package's on tests/test_quincy_device.py's instances — the objective
instances, the bounded window, the compaction ladder, preemption with
groups and the steady-shape two-stage solve — plus the grouped
rounds of a steady run on the JAX package's draws. Tolerance 0: every
stat and state array equal with its dtype."""

import numpy as np
import pytest

from ksched_tpu.costmodels.quincy_device import QuincyGroupTable as JaxTable
from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster as JaxCluster
from ksched_tpu_torch.costmodels.quincy_device import PREF_NONE, QuincyGroupTable
from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster
from ksched_tpu_torch.solver.layered import read_branch

MB = 1 << 20


def _tables(**kw):
    return JaxTable(**kw), QuincyGroupTable(**kw)


def _same_table(a, b):
    for k in ("cls", "job", "e", "u", "pref_w", "wait_rounds"):
        x, y = getattr(a, k), getattr(b, k)
        assert y.dtype == x.dtype, k
        np.testing.assert_array_equal(y, x, err_msg=k)
    assert (a.overflowed, a.evicted, a._next, a._free) == (
        b.overflowed, b.evicted, b._next, b._free)
    np.testing.assert_array_equal(b.effective_u(), a.effective_u())


def _dedupe(t):
    t.blocks.register(1, 512 * MB, [0])
    t.blocks.register(2, 512 * MB, [1])
    return [t.group_for(0, [1]), t.group_for(0, [1]), t.group_for(0, [2]),
            t.group_for(0, [])]


def _overflow(t):
    t.blocks.register(1, 512 * MB, [0])
    t.blocks.register(2, 256 * MB, [1])
    return [t.group_for(0, [1]), t.group_for(0, [2])]


def _lru(t):
    for b, size, m in ((1, 512, 0), (2, 256, 1), (3, 128, 2)):
        t.blocks.register(b, size * MB, [m])
    g = [t.group_for(0, [1]), t.group_for(0, [2]), t.group_for(0, [3]),
         t.group_for(0, [1])]
    live = np.zeros(4, np.int64)
    live[g[0]] = 5
    g.append(t.evict_idle(live, keep_fraction=0.0))
    t.blocks.register(4, 64 * MB, [3])
    g.append(t.group_for(0, [4]))
    live[g[-1]] = 1
    g.append(t.evict_idle(live, keep_fraction=1.0))
    g.append(t.group_for(0, [2]))
    return g


def _split_quanta(t):
    t.blocks.register(1, 512 * MB, [0])
    t.blocks.register(2, 513 * MB, [0])
    t.blocks.register(3, 100 * MB, [])
    return [t.group_for(0, [1]), t.group_for(0, [2]), t.group_for(0, [3]),
            t.group_for(0, [])]


def _unpin(t):
    for b, size, m in ((1, 512, 0), (2, 256, 1), (3, 128, 2)):
        t.blocks.register(b, size * MB, [m])
    g = [t.group_for(0, [1]), t.group_for(0, [2]), t.group_for(0, [3])]
    live = np.zeros(4, np.int64)
    live[g[0]] = 2
    g.append(t.evict_idle(live, keep_fraction=0.0))
    g.append(t.group_for(0, [3]))
    return g


def _drop_and_age(t):
    t.blocks.register(1, 512 * MB, [2])
    t.blocks.register(5, 256 * MB, [0, 1])
    g = [t.group_for(0, [1]), t.group_for(0, [5]), t.group_for(0, [1, 5])]
    t.drop_machine(2)
    t.bump_wait(np.eye(1, 8, g[0], dtype=np.int64)[0])
    t.bump_wait(np.eye(1, 8, g[1], dtype=np.int64)[0] * 3)
    return g


def _quincy10k(t):
    """quincy10k's table at full size (bench.py:1581-1599, the port's
    drivers/device_bulk.py quincy_setup, in its draw order): 480 blocks
    of 512 MB on 3 of 1,000 machines, 10,000 tasks reading one each."""
    rng = np.random.default_rng(0)
    for b in range(1, 481):
        t.blocks.register(b, 512 * MB, rng.choice(1000, size=3, replace=False).tolist())
    blocks = rng.integers(1, 481, 10_000)
    return t.groups_for(np.zeros(10_000, np.int32), [[int(b)] for b in blocks]).tolist()


@pytest.mark.parametrize("scenario,kw", [
    (_dedupe, dict(num_groups=8, num_machines=4)),
    (_overflow, dict(num_groups=3, num_machines=4)),
    (_lru, dict(num_groups=4, num_machines=4)),
    (_split_quanta, dict(num_groups=6, num_machines=4, cost_unit_mb=1, sig_unit_mb=128)),
    (_overflow, dict(num_groups=2, num_machines=4, cost_unit_mb=1, sig_unit_mb=128)),
    (_unpin, dict(num_groups=4, num_machines=4)),
    (_drop_and_age, dict(num_groups=8, num_machines=4, num_classes=2, cost_unit_mb=64)),
    (_quincy10k, dict(num_groups=512, num_machines=1000, cost_unit_mb=64)),
], ids=["dedupe", "overflow", "lru", "split-quanta", "overflow-ratchet", "unpin",
        "drop-and-age", "quincy10k"])
def test_group_table_matches(scenario, kw):
    """tests/test_quincy_device.py:30-220: the same registrations on both
    tables give the same group ids, rows, counters and free list."""
    a, b = _tables(**kw)
    assert scenario(b) == scenario(a)
    _same_table(a, b)


def test_group_table_refuses_finer_signature_quantum():
    with pytest.raises(ValueError):
        QuincyGroupTable(num_groups=4, num_machines=2, cost_unit_mb=64, sig_unit_mb=1)
    with pytest.raises(ValueError):
        QuincyGroupTable(num_groups=1, num_machines=2)


def _pair(**kw):
    return JaxCluster(**kw), DeviceBulkCluster(device="cpu", **kw)


def _same(jc, tc, a, b):
    a, b = jc.fetch_stats(a), tc.fetch_stats(b)
    assert set(a) == set(b)
    for k in a:
        x = np.asarray(a[k])
        assert b[k].dtype == x.dtype, k
        np.testing.assert_array_equal(b[k], x, err_msg=k)
    js, ts = jc.fetch_state(), tc.fetch_state()
    for k in js:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objective_instances_match(seed):
    """tests/test_quincy_device.py:287's instances (10 tasks on 8 slots,
    random block placement): the one-shot grouped round equal."""
    rng = np.random.default_rng(seed)
    M, B = 4, 5
    locs = {b: sorted(rng.choice(M, size=int(rng.integers(1, 3)), replace=False).tolist())
            for b in range(1, B + 1)}
    blocks = [sorted(rng.choice(np.arange(1, B + 1), size=int(rng.integers(0, 3)),
                                replace=False).tolist()) for _ in range(10)]
    table = QuincyGroupTable(num_groups=32, num_machines=M)
    for b, m in locs.items():
        table.blocks.register(b, 512 * MB, m)
    groups = table.groups_for(np.zeros(10, np.int32), blocks)
    jc, tc = _pair(num_machines=M, pus_per_machine=2, slots_per_pu=1, num_jobs=1,
                   num_task_classes=1, task_capacity=32, num_groups=32)
    for c in (jc, tc):
        table.sync(c)
        c.add_tasks(10, groups=groups)
    s = _same(jc, tc, jc.round(), tc.round())
    assert bool(s["converged"]) and int(s["placed"]) == 8


@pytest.mark.parametrize("width", [None, 16])
def test_bounded_window_steady_rounds_match(width):
    """tests/test_quincy_device.py:334: grouped steady rounds, arrivals
    drawn over the arrival map, with and without the decode window."""
    table = QuincyGroupTable(num_groups=16, num_machines=3)
    table.blocks.register(1, 512 * MB, [1])
    table.blocks.register(2, 512 * MB, [2])
    groups = table.groups_for(np.zeros(8, np.int32), [[1]] * 3 + [[2]] * 3 + [[]] * 2)
    jc, tc = _pair(num_machines=3, pus_per_machine=2, slots_per_pu=2, num_jobs=1,
                   num_task_classes=1, task_capacity=16, num_groups=16,
                   decode_width=width)
    for c in (jc, tc):
        table.sync(c)
        c.add_tasks(8, groups=groups)
    _same(jc, tc, jc.round(), tc.round())
    s = _same(jc, tc, jc.run_steady_rounds(4, 0.3, 1, seed=7),
              tc.run_steady_rounds(4, 0.3, 1, seed=7))
    assert s["converged"].all()


@pytest.mark.parametrize("caps", [16, (2, 6), (1, 4, 12)], ids=str)
def test_active_cap_ladder_matches(caps):
    """tests/test_quincy_device.py:361: rounds whose tasks read from 1, 3
    and 8 blocks through each ladder — the rung taken and every value equal;
    one branch read per grouped solve."""
    table = QuincyGroupTable(num_groups=16, num_machines=4)
    for b in range(1, 9):
        table.blocks.register(b, 512 * MB, [b % 4])
    jc, tc = _pair(num_machines=4, pus_per_machine=2, slots_per_pu=2, num_jobs=1,
                   num_task_classes=1, task_capacity=64, num_groups=16,
                   active_groups_cap=caps)
    assert tc.active_groups_caps == jc.active_groups_caps
    r = np.random.default_rng(3)
    rungs = []
    for n_groups in (1, 3, 8):
        blocks = [[int(r.integers(1, n_groups + 1))] for _ in range(6)]
        groups = table.groups_for(np.zeros(6, np.int32), blocks)
        for c in (jc, tc):
            table.sync(c)
            c.add_tasks(6, groups=groups)
        reads = read_branch.count
        s = _same(jc, tc, jc.round(), tc.round())
        assert read_branch.count - reads == 1
        rungs.append(tc.last_grouped_path[0])
        assert bool(s["converged"])
        done = np.nonzero(tc.fetch_state()["live"])[0].astype(np.int32)
        for c in (jc, tc):
            c.complete_tasks(done)
    if caps == (1, 4, 12):
        assert rungs == [1, 4, 4]  # 1, then 3 and 4 active groups


def test_preemption_with_groups_matches():
    """tests/test_quincy_device.py:391: a new preference migrates the
    residents toward it, on the tiered solve with group rows."""
    jc, tc = _pair(num_machines=2, pus_per_machine=1, slots_per_pu=2, num_jobs=1,
                   num_task_classes=1, task_capacity=8, num_groups=2,
                   preemption=True, continuation_discount=1)
    pref = np.full((2, 2), PREF_NONE, np.int64)
    for c in (jc, tc):
        c.set_groups(cls=[0, 0], job=[0, 0], e=[100, 100], u=[500, 500], pref_w=pref)
        c.add_tasks(2, groups=np.array([1, 1], np.int32))
    _same(jc, tc, jc.round(), tc.round())
    pref[1, 1] = 10
    for c in (jc, tc):
        c.set_groups(pref_w=pref)
    _same(jc, tc, jc.round(), tc.round())
    assert (tc.fetch_state()["pu"][:2] == 1).all()


@pytest.mark.parametrize("two_stage_eps0", ["one", "quarter"])
def test_steady_shape_two_stage_matches(two_stage_eps0):
    """tests/test_quincy_device.py:413: residents on their preferred
    machines, a churned backlog over 24 groups with two preferred
    machines each — the two-stage decomposition (stage 1 and, where it
    runs out of budget, the fallback) equal in both packages."""
    rng = np.random.default_rng(42)
    M, G = 64, 24
    jc, tc = _pair(num_machines=M, pus_per_machine=2, slots_per_pu=2, num_jobs=1,
                   num_task_classes=1, task_capacity=512, num_groups=G,
                   supersteps=1 << 15, two_stage_eps0=two_stage_eps0)
    pref = np.full((G, M), PREF_NONE, np.int64)
    for g in range(G):
        pref[g, rng.choice(M, 2, replace=False)] = 0
    g0 = rng.integers(0, G, 200).astype(np.int32)
    for c in (jc, tc):
        c.set_groups(cls=np.zeros(G), job=np.zeros(G), e=np.full(G, 512),
                     u=np.full(G, 513), pref_w=pref)
        c.add_tasks(200, groups=g0)
    _same(jc, tc, jc.round(), tc.round())
    st = tc.fetch_state()
    done = rng.choice(np.nonzero(st["live"] & (st["pu"] >= 0))[0], 30, replace=False)
    g_new = rng.integers(0, G, 30).astype(np.int32)
    for c in (jc, tc):
        c.complete_tasks(done)
        c.add_tasks(30, groups=g_new)
    s = _same(jc, tc, jc.round(), tc.round())
    assert bool(s["converged"]) and int(s["supersteps"]) < 2000
    assert tc.last_grouped_path[1] in ("two-stage", "fallback")


def test_grouped_steady_rounds_with_arrival_map_and_preemption():
    """Grouped steady rounds on the JAX draws with arrivals restricted to
    a registered subset (set_arrival_groups), then the three-tier
    scheme over group rows: every round equal."""
    rng = np.random.default_rng(5)
    M, G = 16, 12
    table = QuincyGroupTable(num_groups=G, num_machines=M, cost_unit_mb=64)
    for b in range(1, 9):
        table.blocks.register(b, 512 * MB, rng.choice(M, 2, replace=False).tolist())
    groups = table.groups_for(np.zeros(60, np.int32),
                              [[int(b)] for b in rng.integers(1, 9, 60)])
    for over in (dict(), dict(preemption=True, continuation_discount=2,
                              preempt_every=3, preempt_drift=8,
                              preempt_global_every=5, preempt_scope_tau=2,
                              preempt_incr_budget=64, track_realized_cost=True)):
        jc, tc = _pair(num_machines=M, pus_per_machine=2, slots_per_pu=2, num_jobs=1,
                       task_capacity=128, num_groups=G, decode_width=32,
                       active_groups_cap=(4, 8), **over)
        for c in (jc, tc):
            table.sync(c)
            c.set_arrival_groups(np.unique(groups))
            c.add_tasks(60, groups=groups)
        _same(jc, tc, jc.round(), tc.round())
        s = _same(jc, tc, jc.run_steady_rounds(12, 0.2, 6, seed=4),
                  tc.run_steady_rounds(12, 0.2, 6, seed=4))
        assert s["converged"].all()
        assert set(np.unique(tc.fetch_state()["grp"][tc.fetch_state()["live"]])) <= set(
            np.unique(groups).tolist())
