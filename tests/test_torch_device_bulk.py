"""The port's DeviceBulkCluster (ksched_tpu_torch scheduler/
device_bulk.py) on the CPU against the JAX package's, bit for bit:
every round's stats and the whole cluster state (placements, per-PU
occupancy, the task table), with preemption on (the tiered solve) and
off (the transport solve), over the fill, host-driven rounds
(drivers/device_bulk.py) and steady rounds fed the JAX package's own
random draws. The shape is tests/test_preemption_device.py's
`_hybrid_cluster`: 40 machines x 4 PUs x 4 slots, 4 jobs, CoCo over 4
classes, continuation discount 8, a 256-row decode window."""

import jax
import numpy as np
import pytest
import torch

from ksched_tpu.costmodels.device_costs import coco_device_cost_fn as jax_coco
from ksched_tpu.costmodels.device_costs import whare_device_cost_fn as jax_whare
from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster as JaxCluster
from ksched_tpu_torch import interop
from ksched_tpu_torch.costmodels import coco
from ksched_tpu_torch.costmodels.device_costs import (
    coco_device_cost_fn,
    whare_device_cost_fn,
)
from ksched_tpu_torch.drivers import device_bulk_rounds
from ksched_tpu_torch.drivers.device_bulk import cluster_args, host_round, run_rounds
from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster, draw_steady

M, T, TCAP = 40, 400, 1024
PEN = np.random.default_rng(7).integers(0, 40, (M, 4)).astype(np.int64)


def _kw(**over):
    kw = dict(
        num_machines=M, pus_per_machine=4, slots_per_pu=4, num_jobs=4,
        num_task_classes=4, task_capacity=TCAP,
        unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0, supersteps=1 << 16,
        preemption=True, continuation_discount=8, decode_width=256,
    )
    kw.update(over)
    return kw


def _pair(cost=True, **over):
    """(JAX cluster, port cluster on the CPU) of one configuration."""
    kw = _kw(**over)
    return (
        JaxCluster(class_cost_fn=jax_coco(PEN) if cost else None, **kw),
        DeviceBulkCluster(class_cost_fn=coco_device_cost_fn(PEN) if cost else None,
                          device="cpu", **kw),
    )


def _ints(stats):
    return {k: np.asarray(v).astype(np.int64).tolist() for k, v in stats.items()}


def _assert_same_state(jc, tc):
    js, ts = jc.fetch_state(), tc.fetch_state()
    assert set(js) == set(ts)
    for k in js:
        a = np.asarray(js[k])
        assert ts[k].dtype == a.dtype, k
        np.testing.assert_array_equal(ts[k], a, err_msg=k)


def _jax_draws(seed, rounds, C, J):
    """The draws of JAX's steady scan (device_bulk.py:1453-1476): per
    round split(key, 4), uniform(k1), randint(k2, 0, C), randint(k3, 0,
    J), randint(k4, (), 0, 1 << 30), as tensors."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), rounds):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        out.append(tuple(torch.as_tensor(np.array(a)) for a in (
            jax.random.uniform(k1, (TCAP,)),
            jax.random.randint(k2, (TCAP,), 0, C),
            jax.random.randint(k3, (TCAP,), 0, J),
            jax.random.randint(k4, (), 0, 1 << 30),
        )))
    return out


def _scenario(jc, tc, host_rounds=3, steady=6, churn=0.05, arrivals=20, seed=3):
    """Fill, host-driven rounds and steady rounds on both clusters,
    checking stats and state after each."""
    for (_r, a), (_r2, b) in zip(run_rounds(jc, T, host_rounds),
                                 run_rounds(tc, T, host_rounds)):
        assert _ints(jc.fetch_stats(a)) == _ints(tc.fetch_stats(b))
        _assert_same_state(jc, tc)
    if steady:
        want = jc.fetch_stats(jc.run_steady_rounds(steady, churn, arrivals, seed=seed))
        for r, draws in enumerate(_jax_draws(seed, steady, tc.C, tc.J)):
            got = _ints(tc.fetch_stats(tc.steady_round(*draws, churn, arrivals)))
            assert got == {k: int(v[r]) for k, v in want.items()}, r
        _assert_same_state(jc, tc)


@pytest.mark.parametrize("preemption", [True, False])
def test_coco_rounds_match(preemption):
    """Preemption on: the tiered re-solve every round (B2's plain
    version), the mover window binding on steady rounds. Off: B1's."""
    jc, tc = _pair(preemption=preemption)
    _scenario(jc, tc)


@pytest.mark.parametrize("over", [
    # per-job escape costs, no class cost model: the row-constant
    # closed form, preemption off and at discount 0
    dict(cost=False, num_task_classes=2, job_unsched_cost=[3, 6, 9, 12],
         preemption=False),
    dict(cost=False, num_task_classes=2, job_unsched_cost=[3, 6, 9, 12],
         continuation_discount=0),
    # no cost model at all: the class-degenerate closed form
    dict(cost=False, num_task_classes=2, preemption=False),
    # tiers coincide at discount 0: the ordinary iterative solve
    dict(continuation_discount=0),
], ids=["row-constant", "row-constant-preempt-d0", "class-degenerate", "coco-preempt-d0"])
def test_other_solve_paths_match(over):
    jc, tc = _pair(**over)
    _scenario(jc, tc, host_rounds=2, steady=3)


def test_machine_toggles_evict_and_match():
    jc, tc = _pair()
    for (_r, a), (_r2, b) in zip(run_rounds(jc, T, 0), run_rounds(tc, T, 0)):
        assert _ints(jc.fetch_stats(a)) == _ints(tc.fetch_stats(b))
    for enabled_steps in ([(3, False), (7, False)], [(3, True)]):
        for m, on in enabled_steps:
            jc.set_machine_enabled(m, on)
            tc.set_machine_enabled(m, on)
            _assert_same_state(jc, tc)
        st = tc.fetch_state()
        placed = st["live"] & (st["pu"] >= 0)
        assert not (placed & ~np.repeat(st["machine_enabled"], 4)[
            np.clip(st["pu"], 0, M * 4 - 1)]).any()
        assert _ints(jc.fetch_stats(jc.round())) == _ints(tc.fetch_stats(tc.round()))
        _assert_same_state(jc, tc)
    with pytest.raises(ValueError):
        tc.set_machine_enabled(M, False)


def test_state_carried_over_from_the_jax_package():
    """JAX's mid-run state, carried into the port with
    interop.device_cluster_state: three more rounds equal on both."""
    jc, tc = _pair()
    rng = np.random.default_rng(11)
    jax.block_until_ready(jc.fetch_stats(next(run_rounds(jc, T, 0))[1]))
    for _ in range(2):
        host_round(jc, rng, 8)
    tc.state = interop.device_cluster_state(jc.fetch_state(), "cpu")
    _assert_same_state(jc, tc)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        a, b = host_round(jc, rj, 8), host_round(tc, rt, 8)
        assert _ints(jc.fetch_stats(a)) == _ints(tc.fetch_stats(b))
        _assert_same_state(jc, tc)


@pytest.mark.parametrize("mode", ["grouped", "hybrid"])
def test_group_and_hybrid_carry_from_the_jax_package(mode):
    """A JAX cluster mid-run — grouped with a restricted arrival map, or
    three-tier preemption between re-solves — carried into a fresh port
    cluster with interop.continue_cluster: the next steady rounds are
    equal."""
    if mode == "grouped":
        over = dict(num_groups=8, active_groups_cap=(2, 4), preemption=False)
    else:
        over = dict(preempt_every=4, preempt_global_every=8, preempt_scope_tau=2,
                    track_realized_cost=True)
    jc, tc = _pair(**over)
    if mode == "grouped":
        jc.set_groups(cls=np.arange(8) % 4, job=np.zeros(8), e=np.zeros(8),
                      u=60 + np.arange(8), pref_w=np.where(
                          PEN[None, :, 0] < 8, PEN[None, :, 1], 1 << 30).repeat(8, 0))
        jc.set_arrival_groups([1, 3, 4, 6])
    rng = np.random.default_rng(4)
    jc.add_tasks(T, rng.integers(0, 4, T).astype(np.int32),
                 groups=(rng.integers(0, 8, T).astype(np.int32)
                         if mode == "grouped" else None))
    jc.fetch_stats(jc.round())
    jc.fetch_stats(jc.run_steady_rounds(5, 0.05, 20, seed=1))
    if mode == "hybrid":
        assert 0 < int(jc._hyb_k) and 0 < int(jc._hyb_kg)  # mid-interval
    interop.continue_cluster(
        tc, jc.fetch_state(),
        groups=({k: np.asarray(v) for k, v in jc.groups._asdict().items()}
                if mode == "grouped" else None),
        arrival=((np.asarray(jc._arrival_map), int(jc._arrival_n))
                 if mode == "grouped" else None),
        hybrid=((np.asarray(jc._hyb_census), int(jc._hyb_k), int(jc._hyb_kg))
                if mode == "hybrid" else None),
    )
    _assert_same_state(jc, tc)
    a = jc.fetch_stats(jc.run_steady_rounds(6, 0.05, 20, seed=2))
    b = tc.fetch_stats(tc.run_steady_rounds(6, 0.05, 20, seed=2))
    assert _ints(a) == _ints(b)
    _assert_same_state(jc, tc)


def _migration_cost_fns():
    """tests/test_preemption_device.py `_device_cost_fn(10, 1, 2)`: cost
    = interference * (other classes on the machine) + (class + 1) *
    base_scale * machine index, for both packages."""
    import jax.numpy as jnp

    base_j = jnp.arange(2, dtype=jnp.int32)

    def jfn(census):
        other = census.sum(axis=1, keepdims=True) - census
        scale = (1 + jnp.arange(census.shape[1], dtype=jnp.int32))[:, None]
        return (10 * other.T + scale * base_j[None, :]).astype(jnp.int32)

    def tfn(census):
        other = census.sum(dim=1, keepdim=True, dtype=torch.int32) - census
        scale = (1 + torch.arange(census.shape[1], dtype=torch.int32))[:, None]
        base = torch.arange(2, dtype=torch.int32)
        return (10 * other.T + scale * base[None, :]).to(torch.int32)

    return jfn, tfn


def _counts(stats):
    return {"PLACE": int(stats["placed"]), "MIGRATE": int(stats["migrated"]),
            "PREEMPT": int(stats["preempted"])}


def test_graph_parity_migration_scenario():
    """tests/test_preemption_device.py:219's device twin: a third
    arrival makes class 0 cheaper elsewhere, so the class-0 resident
    MIGRATES, the arrival PLACES, the class-1 resident stays — as the
    host graph path decides there."""
    jfn, tfn = _migration_cost_fns()
    kw = dict(num_machines=2, pus_per_machine=1, slots_per_pu=2, num_jobs=1,
              num_task_classes=2, task_capacity=16, preemption=True,
              continuation_discount=1, unsched_cost=30, ec_cost=0)
    jc = JaxCluster(class_cost_fn=jfn, **kw)
    tc = DeviceBulkCluster(class_cost_fn=tfn, device="cpu", **kw)
    for classes in ([0, 1], [0]):
        for c in (jc, tc):
            c.add_tasks(len(classes), classes=np.array(classes, np.int32))
        a, b = jc.fetch_stats(jc.round()), tc.fetch_stats(tc.round())
        assert _ints(a) == _ints(b)
        _assert_same_state(jc, tc)
    assert _counts(b) == {"PLACE": 1, "MIGRATE": 1, "PREEMPT": 0}


def test_graph_parity_preempt_scenario():
    """tests/test_preemption_device.py:271's device twin: a cost spike
    above the escape price PREEMPTS the resident and leaves both tasks
    unscheduled."""
    kw = dict(num_machines=1, pus_per_machine=1, slots_per_pu=1, num_jobs=1,
              num_task_classes=1, task_capacity=8, preemption=True,
              continuation_discount=1, unsched_cost=30, ec_cost=0)
    jc = JaxCluster(
        class_cost_fn=lambda cen: (35 * cen.sum(axis=1, keepdims=True).T).astype(
            np.int32), **kw)
    tc = DeviceBulkCluster(
        class_cost_fn=lambda cen: 35 * cen.sum(dim=1, keepdim=True, dtype=torch.int32).T,
        device="cpu", **kw)
    for _ in range(2):
        for c in (jc, tc):
            c.add_tasks(1)
        a, b = jc.fetch_stats(jc.round()), tc.fetch_stats(tc.round())
        assert _ints(a) == _ints(b)
    assert _counts(b) == {"PLACE": 0, "MIGRATE": 0, "PREEMPT": 1}
    assert tc.num_placed_tasks == 0 and int(b["unscheduled"]) == 2


def test_cost_overflow_raises():
    """Costs too large for int32 once scaled are flagged in the round
    and raised by fetch_stats, as in the JAX package."""
    def jfn(census):
        return (census.T * 0 + (1 << 27)).astype(np.int32)

    def tfn(census):
        return census.T * 0 + (1 << 27)

    kw = dict(num_machines=4, pus_per_machine=1, slots_per_pu=2, num_jobs=1,
              num_task_classes=2, task_capacity=16, preemption=True,
              continuation_discount=8, supersteps=64)
    jc = JaxCluster(class_cost_fn=jfn, **kw)
    tc = DeviceBulkCluster(class_cost_fn=tfn, device="cpu", **kw)
    for c in (jc, tc):
        c.add_tasks(4, classes=np.array([0, 1, 0, 1], np.int32))
        stats = c.round()
        with pytest.raises(OverflowError):
            c.fetch_stats(stats)


@pytest.mark.parametrize("option", [
    dict(num_groups=4),
    dict(preempt_every=2),
    dict(preempt_drift=5),
    dict(preempt_global_every=3, preempt_every=2),
    dict(preempt_incr_budget=10, preempt_every=2, preempt_global_every=3),
    dict(track_realized_cost=True, preempt_every=2),
], ids=lambda o: next(iter(o)))
def test_options_match_the_jax_package(option):
    """Each option of group mode and of the stability-aware and
    three-tier preemption schemes: a cluster with it runs the fill, two
    host-driven rounds and six steady rounds (each package's own
    run_steady_rounds(seed)) equal to the JAX package's."""
    jc, tc = _pair(**option)
    if tc.grouped:
        # one group per class, group g escaping at 60 + g
        for c in (jc, tc):
            c.set_groups(cls=np.arange(4), job=np.zeros(4), e=np.zeros(4),
                         u=60 + np.arange(4))
    rng = np.random.default_rng(2)
    for r in range(3):
        n = T if r == 0 else 8
        jobs = rng.integers(0, 4, n).astype(np.int32)
        classes = rng.integers(0, 4, n).astype(np.int32)
        groups = classes if tc.grouped else None
        for c in (jc, tc):
            c.add_tasks(n, jobs, classes, groups=groups)
        assert _ints(jc.fetch_stats(jc.round())) == _ints(tc.fetch_stats(tc.round()))
        _assert_same_state(jc, tc)
    a = jc.fetch_stats(jc.run_steady_rounds(6, 0.05, 20, seed=9))
    b = tc.fetch_stats(tc.run_steady_rounds(6, 0.05, 20, seed=9))
    assert _ints(a) == _ints(b)
    _assert_same_state(jc, tc)


def _schedule(seed, K=5, A=30, D=12, E=3):
    """A hand-made replay schedule: per window up to A admissions, D
    completions of random rows (dead rows are ignored by the round) and
    E toggles of distinct machines."""
    rng = np.random.default_rng(seed)
    sch = {
        "adm_job": rng.integers(0, 4, (K, A)).astype(np.int32),
        "adm_cls": rng.integers(0, 4, (K, A)).astype(np.int32),
        "adm_grp": rng.integers(0, 4, (K, A)).astype(np.int32),
        "adm_n": rng.integers(0, A + 1, K).astype(np.int32),
        "done_rows": rng.integers(0, TCAP, (K, D)).astype(np.int32),
        "done_n": rng.integers(0, D + 1, K).astype(np.int32),
        "tog_idx": np.stack([rng.choice(M, E, replace=False) for _ in range(K)]).astype(np.int32),
        "tog_on": rng.random((K, E)) < 0.5,
        "tog_n": rng.integers(0, E + 1, K).astype(np.int32),
    }
    sch["adm_cls"] = sch["adm_grp"]  # group g is class g below
    return sch


@pytest.mark.parametrize("option", [
    dict(), dict(preemption=False), dict(preempt_every=2, preempt_global_every=3),
    dict(num_groups=4, preemption=False),
], ids=["preempt", "off", "three-tier", "grouped"])
def test_replay_rounds_in_each_round_kind(option):
    """run_replay_rounds after a fill, in each round kind, two calls with
    their own seeds: stats and state equal the JAX package's."""
    jc, tc = _pair(**option)
    if tc.grouped:
        for c in (jc, tc):
            c.set_groups(cls=np.arange(4), job=np.zeros(4), e=np.zeros(4),
                         u=60 + np.arange(4))
    for (_r, a), (_r2, b) in zip(run_rounds(jc, 300, 0), run_rounds(tc, 300, 0)):
        assert _ints(jc.fetch_stats(a)) == _ints(tc.fetch_stats(b))
    for seed in (4, 9):
        sch = _schedule(seed)
        a = jc.fetch_stats(jc.run_replay_rounds(sch, seed=seed))
        b = tc.fetch_stats(tc.run_replay_rounds(sch, seed=seed))
        assert _ints(a) == _ints(b)
        assert {"evicted", "admitted", "completed"} <= set(b)
        _assert_same_state(jc, tc)


def test_replay_rounds_and_no_card_raise(monkeypatch):
    """A replay schedule runs on the CPU (no NotImplementedError left);
    asking for the card where there is none raises."""
    tc = DeviceBulkCluster(**_kw(), device="cpu")
    got = tc.fetch_stats(tc.run_replay_rounds(_schedule(1, K=2), seed=0))
    assert got["admitted"].shape == (2,) and got["converged"].all()
    assert tc.run_replay_rounds({k: v[:0] for k, v in _schedule(1).items()}) == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBulkCluster(**_kw())


@pytest.mark.parametrize("seed", range(3))
def test_device_cost_fns_match(seed):
    """CoCo and Whare-Map on a census: the port's integer products equal
    the JAX package's matrix products, clamps and floor divisions
    included (censuses large enough to reach both MAX_COSTs)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    census = rng.integers(0, 90, (37, 4)).astype(np.int32)
    census[rng.integers(0, 37, 5)] = 0  # idle machines
    pen = rng.integers(0, 40, (37, 4))
    psi = rng.integers(0, 1500, (4, 4))
    plat = rng.integers(50, 250, 37)
    for jfn, tfn in (
        (jax_coco(), coco_device_cost_fn()),
        (jax_coco(pen), coco_device_cost_fn(pen)),
        (jax_whare(64), whare_device_cost_fn(64)),
        (jax_whare(64, psi, plat), whare_device_cost_fn(64, psi, plat)),
    ):
        got = tfn(torch.as_tensor(census))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jnp.asarray(census))))


def test_driver_config_matches_at_full_width():
    """drivers/device_bulk.py's 10kx1k config (10k tasks on 1k machines,
    the closed form) on the CPU: every round and the final state equal to
    the JAX package's cluster with the same arguments."""
    tasks, kw, _pen = cluster_args("10kx1k")
    jc = JaxCluster(**kw)
    for (_r, a), (_r2, tc, b) in zip(run_rounds(jc, tasks, 2),
                                     device_bulk_rounds("10kx1k", 2, device="cpu")):
        assert _ints(jc.fetch_stats(a)) == _ints(tc.fetch_stats(b))
    _assert_same_state(jc, tc)
    assert tc.num_live_tasks == tasks == tc.num_placed_tasks


@pytest.mark.parametrize("config", ["ref100", "whare-hetero"])
def test_suite_configs_match(config):
    """drivers/device_bulk.py's ref100 (its own size, 5% churn, the
    closed form) and whare-hetero (Whare-Map with platform factors, cut
    to 40 machines and 1,200 tasks): the fill, two host-driven rounds and
    steady rounds on the JAX package's draws equal the JAX package's."""
    from ksched_tpu.costmodels import device_costs as jax_costs
    from ksched_tpu_torch.drivers.device_bulk import churn_of, cost_fn

    tasks, kw, cost = cluster_args(config)
    if config == "whare-hetero":
        tasks, kw = 1_200, dict(kw, num_machines=M, task_capacity=TCAP * 4)
        cost = ("whare", dict(cost[1], platform_factor=cost[1]["platform_factor"][:M]))
    churn = churn_of(config)
    jc = JaxCluster(class_cost_fn=cost_fn(cost, jax_costs), **kw)
    tc = DeviceBulkCluster(class_cost_fn=cost_fn(cost), device="cpu", **kw)
    for (_r, a), (_r2, b) in zip(run_rounds(jc, tasks, 2, churn=churn),
                                 run_rounds(tc, tasks, 2, churn=churn)):
        assert _ints(jc.fetch_stats(a)) == _ints(tc.fetch_stats(b))
        _assert_same_state(jc, tc)
    arrivals = max(1, int(tasks * churn))
    a = jc.fetch_stats(jc.run_steady_rounds(8, churn, arrivals, seed=1))
    b = tc.fetch_stats(tc.run_steady_rounds(8, churn, arrivals, seed=1))
    assert _ints(a) == _ints(b)
    _assert_same_state(jc, tc)
    if config == "whare-hetero":
        assert b["supersteps"].max() > 0  # the iterative solve
    else:
        assert tc.C == 1 and b["supersteps"].max() == 0


def test_steady_rounds_on_a_generator_keep_occupancy():
    """run_steady_rounds on a torch.Generator: every round converges and
    the occupancy invariants of tools/soak.py hold."""
    _jc, tc = _pair()
    for _r, stats in run_rounds(tc, T, 0):
        tc.fetch_stats(stats)
    gen = torch.Generator().manual_seed(1)
    d = draw_steady(torch.Generator().manual_seed(1), TCAP, 4, 4)
    assert [t.dtype for t in d] == [torch.float32, torch.int32, torch.int32, torch.int32]
    assert [tuple(t.shape) for t in d] == [(TCAP,), (TCAP,), (TCAP,), ()]
    got = tc.fetch_stats(tc.run_steady_rounds(4, 0.05, 20, generator=gen))
    assert got["converged"].all() and got["supersteps"].shape == (4,)
    st = tc.fetch_state()
    placed = st["live"] & (st["pu"] >= 0)
    np.testing.assert_array_equal(
        np.bincount(st["pu"][placed], minlength=tc.num_pus), st["pu_running"])
    assert (st["pu_running"] <= tc.S).all()
