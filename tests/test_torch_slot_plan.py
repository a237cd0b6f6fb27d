"""The slot-stable CSR plan (ksched_tpu_torch/graph/slot_plan.py) against
the JAX package's SlotPlanState (ksched_tpu/graph/slot_plan.py), round by
round, bit for bit (tolerance 0: integer bookkeeping): the host plan
tensors (`host_args()`), the packed records (`drain_records()`), the
layout counters (layout_gen, value_version, static_version, rebuilds,
overflows, relocations) and the allocator state, over the churn script
of tests/test_slot_plan.py and its cases: bucket growth and region
overflow, a recycled id, a relocation riding the scatter and a clean
round that ships no plan bytes. Both sides are driven by the same
mutations (tests/torch_plan_twin.py); the port solves with CsrSolver on
the CPU beside JaxSolver, so the flows are held equal too."""

import numpy as np
import pytest
import torch

from ksched_tpu_torch.graph import slot_plan as tsp

from torch_plan_twin import SCRIPT, Pair, assert_plans_equal, churn_round


@pytest.mark.parametrize("nt,nm", [(8, 3), (24, 5), (56, 9)])
def test_plan_matches_jax_over_the_churn_script(nt, nm):
    # machine capacities that hold every task: the solves stay in the
    # eps-1 attempt (the starved default runs the cost-scaling one,
    # minutes of Python supersteps on the CPU)
    pair = Pair(nt, nm, resident=False, machine_cap=(nt, nt + 4))
    rng = np.random.default_rng(7)
    pair.solve_round("round 0")
    for rnd, kind in enumerate(SCRIPT, 1):
        churn_round(pair, kind, rng)
        for a, b in zip(pair.j.plan.drain_records(), pair.t.plan.drain_records()):
            assert b.dtype == a.dtype == np.int32
            np.testing.assert_array_equal(b, a, err_msg=f"round {rnd} ({kind})")
        pair.solve_round(f"round {rnd} ({kind})")


def test_bucket_growth_and_region_overflow():
    """m_cap growth invalidates the layout (one rebuild on the next
    solve); then arcs among the nodes until a region outgrows what the
    tail pool can house: region_overflows, another rebuild. Both in
    lockstep with JAX."""
    pair = Pair(10, 4)
    pair.solve_round("round 0")
    pair.solve_round("round 1")
    nodes = pair.tasks + pair.machines
    pairs = iter((a, b) for a in nodes for b in nodes if a != b)
    m0, gen0 = pair.t.m_cap, pair.t.plan.layout_gen
    while pair.t.m_cap == m0:
        a, b = next(pairs)
        if (a, b) not in pair.t._arc_slot:
            pair.arc(a, b, 1, 5)
    assert pair.t.plan.needs_rebuild
    pair.solve_round("after growth")
    assert pair.t.plan.layout_gen > gen0
    assert pair.tres.last_plan_kind == "rebuild"
    overflows0, relocations0, m1 = (pair.t.plan.region_overflows,
                                    pair.t.plan.region_relocations, pair.t.m_cap)
    while pair.t.plan.region_overflows == overflows0:
        a, b = next(pairs)
        if (a, b) not in pair.t._arc_slot:
            pair.arc(a, b, 1, 5)
            assert_plans_equal(pair.j.plan, pair.t.plan, f"arc {a}->{b}")
    assert pair.t.m_cap == m1
    assert pair.t.plan.region_relocations > relocations0
    pair.solve_round("after overflow")
    assert pair.tres.last_plan_kind == "rebuild"


def test_clean_round_ships_no_plan_bytes():
    pair = Pair(8, 3)
    pair.solve_round("round 0")  # the plan becomes enabled
    pair.solve_round("round 1")  # the mirror uploads the layout
    assert pair.tres.last_plan_kind == "rebuild"
    s, d = pair.live()[0]
    pair.arc(s, d, 2, 7)
    gen = pair.t.endpoint_gen
    pair.solve_round("cost-only round")
    assert pair.t.endpoint_gen == gen
    assert (pair.tres.last_plan_kind, pair.tres.last_plan_bytes,
            pair.tres.last_upload_kind) == ("clean", 0, "delta")


def test_recycled_id_rebuilds_once_then_scatters():
    pair = Pair(10, 4)
    pair.solve_round("round 0")
    pair.solve_round("round 1")
    t = pair.tasks[0]

    def recycle():
        for s, d in [k for k in pair.live() if k[0] == t]:
            pair.kill(s, d)
        for m in pair.machines:
            pair.arc(t, m, 1, 3)

    recycle()
    pair.solve_round("record-setting recycle")
    rebuilds = pair.t.plan.layout_rebuilds
    for rnd in range(4):
        recycle()
        pair.solve_round(f"steady recycle {rnd}")
        assert pair.t.plan.layout_rebuilds == rebuilds
        assert pair.tres.last_plan_kind == "delta"


def test_region_relocation_rides_the_scatter():
    pair = Pair(10, 4)
    pair.solve_round("round 0")
    pair.solve_round("round 1")
    rebuilds = pair.t.plan.layout_rebuilds
    t = pair.tasks[0]
    for d in pair.machines + pair.tasks[1:8]:
        if (t, d) not in pair.t._arc_slot:
            pair.arc(t, d, 1, 3)
    assert pair.t.plan.region_relocations >= 1
    assert pair.t.plan.layout_rebuilds == rebuilds
    pair.solve_round("relocated")
    assert pair.tres.last_plan_kind == "delta"
    assert pair.tres.last_plan_records > 0
    rng = np.random.default_rng(11)
    for rnd in range(3):
        churn_round(pair, "rewire", rng)
        pair.solve_round(f"rewire {rnd}")
        assert pair.t.plan.layout_rebuilds == rebuilds


def test_plan_apply_equals_the_host_arrays():
    """`plan_apply` on tensors equals the host arrays the records were
    drained from, with padding duplicates, int64 indices and bool
    columns; the tensors are updated in place."""
    pair = Pair(24, 5, resident=False)
    pair.t.plan.ensure_built()
    plan = pair.t.plan
    tensors = tuple(torch.tensor(x) for x in plan.host_args())
    ptrs = [t.data_ptr() for t in tensors]
    rng = np.random.default_rng(3)
    for kind in ("rewire", "recycle", "rewire"):
        churn_round(pair, kind, rng)
        recs = plan.drain_records()
        tsp.plan_apply(tensors, *(torch.tensor(r) for r in recs))
        for i, (t, h) in enumerate(zip(tensors, plan.host_args())):
            assert t.numpy().dtype == h.dtype
            np.testing.assert_array_equal(t.numpy(), h, err_msg=str(i))
    assert [t.data_ptr() for t in tensors] == ptrs


def test_sharded_layout_is_not_ported():
    """The sharded layout this test once found refused is ported now:
    under its first name it holds `shard_owner`, `enable_sharding`'s
    block layout and `drain_records_sharded` equal to the JAX
    package's (tests/test_torch_sharded_plan.py has the full churn)."""
    from ksched_tpu.graph import slot_plan as jsp

    np.testing.assert_array_equal(tsp.shard_owner(np.arange(4), 4, 2),
                                  jsp.shard_owner(np.arange(4), 4, 2))
    pair = Pair(6, 3, resident=False)
    for st in (pair.j, pair.t):
        st.plan.enable_sharding(2)
        st.plan.ensure_built()
    assert_plans_equal(pair.j.plan, pair.t.plan, "sharded layout")
    churn_round(pair, "rewire", np.random.default_rng(1))
    for a, b in zip(pair.j.plan.drain_records_sharded(),
                    pair.t.plan.drain_records_sharded()):
        np.testing.assert_array_equal(b, a)
