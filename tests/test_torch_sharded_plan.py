"""The sharded slot-plan layout (ksched_tpu_torch/graph/slot_plan.py in
`enable_sharding` mode), the legacy sharded plan and the sharded
resident mirror against the JAX package's, tolerance 0 (integer
bookkeeping):

- the layout over tests/test_slot_plan.py's churn script at D = 2, 4
  and 5 (one shard owning less): plan tensors, region table, per-slot
  positions, owner map, per-block tail frontiers and dead spans, and
  `drain_records_sharded`'s routed records every round; the port's
  CsrSolver on that layout solves as the JAX package's JaxSolver;
- empty shards (D near and above the node bucket) keep the invariants,
  and a tail pool past its block is caught;
- ownership: `shard_owner` and `node_owner` agree with the JAX
  package's, and `build_sharded_plan`'s per-shard tables equal its;
- the partition rules and `place_sharded_plan`;
- the mirror, on gloo ranks (one spawn of 4): per round the plan sync
  kind, the global plan bytes (the JAX package's [D, K, cols] total,
  held against its own resident mirror) and each rank's, the psum'd
  fingerprints against the host twins, every rank's block against the
  host plan; a poison flip of one element lands on its owner rank only,
  the audit sees it on every rank, the diff names it and the reupload
  repairs it.
"""

import numpy as np
import pytest

from torch_plan_twin import SCRIPT, Pair, assert_plans_equal, churn_round


def _layout(plan):
    from ksched_tpu_torch.interop import sharded_layout

    return sharded_layout(plan)


def _assert_layouts_equal(a, b, where=""):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{where} {k}")
            assert b[k].dtype == a[k].dtype or k in ("owner", "tail_next"), (where, k)
        else:
            assert b[k] == a[k], (where, k)


@pytest.mark.parametrize("D", [2, 4, 5])
def test_sharded_layout_matches_jax_over_the_churn_script(D):
    pair = Pair(24, 5, resident=False, machine_cap=(24, 28))
    for st in (pair.j, pair.t):
        st.plan.enable_sharding(D)
    rng = np.random.default_rng(7)
    pair.solve_round("round 0")
    _assert_layouts_equal(_layout(pair.j.plan), _layout(pair.t.plan), "round 0")
    assert pair.t.plan.block_extent * D == pair.t.plan.entry_cap
    for rnd, kind in enumerate(SCRIPT, 1):
        churn_round(pair, kind, rng)
        for a, b in zip(pair.j.plan.drain_records_sharded(),
                        pair.t.plan.drain_records_sharded()):
            assert b.dtype == a.dtype == np.int32
            np.testing.assert_array_equal(b, a, err_msg=f"round {rnd} ({kind})")
        pair.solve_round(f"round {rnd} ({kind})")
        _assert_layouts_equal(_layout(pair.j.plan), _layout(pair.t.plan), f"round {rnd}")


def test_sharded_layout_relocations_stay_in_the_owner_block():
    """Rewires onto one machine until its region relocates: the new span
    is claimed in the owner's block (its dead-span list or its tail),
    both packages alike."""
    pair = Pair(24, 5, resident=False, machine_cap=(24, 28))
    for st in (pair.j, pair.t):
        st.plan.enable_sharding(2)
    pair.solve_round("round 0")
    hub = pair.machines[0]
    for i, t in enumerate(pair.tasks):
        if (t, hub) not in pair.j._arc_slot:
            pair.arc(t, hub, 1, i % 7)
    pair.solve_round("after growth")
    assert pair.t.plan.region_relocations == pair.j.plan.region_relocations > 0
    owner = _layout(pair.t.plan)["owner"][hub]
    start = int(pair.t.plan.region_start[hub])
    assert start // pair.t.plan.block_extent == owner
    assert_plans_equal(pair.j.plan, pair.t.plan, "relocated")


@pytest.mark.parametrize("extra", [0, 3])
def test_empty_shards_keep_the_invariants(extra):
    """ceil-division ranges leave trailing shards empty when the shard
    count nears or passes the node bucket: one dead slot and its tail
    per empty block, the invariants hold, and the single-device solve on
    the odd layout equals the JAX package's on its own."""
    pair = Pair(8, 3, resident=False, machine_cap=(8, 12))
    n_cap = pair.t.n_cap
    for D in (5, 7, n_cap + extra):
        for st in (pair.j, pair.t):
            st.plan.invalidate()
            st.plan.enable_sharding(D)
            st.plan.ensure_built()
        pair.t.plan.check_invariants()
        _assert_layouts_equal(_layout(pair.j.plan), _layout(pair.t.plan), f"D={D}")
    pair.solve_round("odd layout")


def test_a_tail_pool_past_its_block_is_caught():
    from ksched_tpu_torch.runtime.integrity import IntegrityError

    pair = Pair(8, 3, resident=False, machine_cap=(8, 12))
    plan = pair.t.plan
    plan.enable_sharding(2)
    plan.ensure_built()
    plan.check_invariants()
    plan._tail_next[0] = plan.block_extent + 1
    with pytest.raises(IntegrityError, match="tail pool overran its shard block"):
        plan.check_invariants()


def test_enable_sharding_rejects_zero_and_is_idempotent():
    pair = Pair(6, 3, resident=False)
    plan = pair.t.plan
    with pytest.raises(ValueError):
        plan.enable_sharding(0)
    plan.enable_sharding(2)
    plan.ensure_built()
    gen = plan.layout_gen
    plan.enable_sharding(2)
    plan.ensure_built()
    assert plan.layout_gen == gen  # same count: no rebuild
    plan.enable_sharding(3)
    plan.ensure_built()
    assert plan.layout_gen == gen + 1 and plan._num_shards == 3


@pytest.mark.parametrize("n,D", [(16, 2), (17, 4), (64, 5), (3, 8)])
def test_owner_agrees_with_the_jax_package(n, D):
    from ksched_tpu.graph.slot_plan import shard_owner as jowner
    from ksched_tpu.parallel.sharded_solver import node_owner as jnode_owner

    from ksched_tpu_torch.graph.slot_plan import shard_owner
    from ksched_tpu_torch.parallel.sharded_solver import node_owner

    ids = np.arange(n)
    np.testing.assert_array_equal(shard_owner(ids, n, D), jowner(ids, n, D))
    np.testing.assert_array_equal(node_owner(ids, n, D), jnode_owner(ids, n, D))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_build_sharded_plan_matches_the_jax_package(D):
    from ksched_tpu.parallel.sharded_solver import build_sharded_plan as jbuild

    from ksched_tpu_torch.interop import SHARDED_PLAN_FIELDS, sharded_plan
    from ksched_tpu_torch.parallel.sharded_solver import build_sharded_plan
    from torch_parallel_cases import legacy_problems

    for p in legacy_problems():
        src, dst = p.src.astype(np.int32), p.dst.astype(np.int32)
        jp = sharded_plan(jbuild(src, dst, p.num_nodes, D))
        tp = build_sharded_plan(src, dst, p.num_nodes, D)
        for f in SHARDED_PLAN_FIELDS:
            a, b = getattr(jp, f), getattr(tp, f)
            np.testing.assert_array_equal(b, a, err_msg=f)
            assert b.dtype == a.dtype, f


def test_partition_rules_match_the_jax_package():
    from ksched_tpu.parallel.sharded_solver import _SLOT_SOLVE_ARGS as JARGS
    from ksched_tpu.parallel.sharded_solver import match_partition_rules as jrules

    from ksched_tpu_torch.parallel.sharded_solver import (
        _SLOT_SOLVE_ARGS,
        match_partition_rules,
        sharded_entry_extent,
    )

    from ksched_tpu.parallel.sharded_solver import sharded_entry_extent as jextent

    names = _SLOT_SOLVE_ARGS + ("warm_p",)
    assert _SLOT_SOLVE_ARGS == JARGS
    got = match_partition_rules(names)
    want = ["sharded" if len(s) else "replicated" for s in jrules(names, "x")]
    assert list(got) == want
    with pytest.raises(ValueError, match="no partition rule"):
        match_partition_rules(("stray",))
    for m_pad, D in ((1 << 10, 4), (64, 8), (16, 2)):
        assert sharded_entry_extent(m_pad, D) == jextent(m_pad, D)


# ---------------------------------------------------------------------------
# the mirror, on gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mirror():
    from ksched_tpu_torch.parallel.launch import run_ranks

    return run_ranks("torch_parallel_cases:mirror_cases", 4)


def _jax_mirror_rows(D):
    """The JAX package's sharded resident mirror over the same script:
    per round (plan kind, plan bytes, plan records, fingerprints)."""
    import jax
    from jax.sharding import Mesh

    from ksched_tpu.graph.device_export import DeviceResidentState

    from torch_plan_twin import JSolo

    mesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    solo = JSolo(16, 4, machine_cap=(16, 20))
    st = solo.j
    st.plan.enable_sharding(D)
    st.plan.ensure_built()
    res = DeviceResidentState(st)
    res.enable_sharded_plan(mesh, "x")
    rng = np.random.default_rng(5)
    rows = []
    for rnd in range(len(SCRIPT) + 1):
        if rnd:
            churn_round(solo, SCRIPT[(rnd - 1) % len(SCRIPT)], rng)
        res.refresh()
        rows.append((res.last_plan_kind, res.last_plan_bytes, res.last_plan_records,
                     [int(f) for f in res.plan_fingerprints()], res.last_upload_bytes))
    return rows


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_mirror_matches_the_jax_package(mirror, D):
    got = mirror[0][f"mirror{D}"]
    want = _jax_mirror_rows(D)
    assert len(got["rows"]) == len(want)
    kinds = []
    for rnd, (row, jrow) in enumerate(zip(got["rows"], want)):
        (kind, nbytes, rank_bytes, records, fps, fp_ok, blocks_ok, no_full,
         block_shape, upload) = row
        assert (kind, nbytes, records, fps, upload) == jrow, rnd
        assert all(fp_ok) and all(blocks_ok) and no_full, rnd
        assert block_shape == (got["block_extent"],)
        if kind == "delta":
            assert 0 < rank_bytes < nbytes  # each rank ships its own slice
        kinds.append(kind)
    assert kinds[0] == "rebuild" and "rebuild" not in kinds[1:]
    assert kinds.count("delta") >= 3
    # every rank saw the same thing
    for r in range(1, D):
        other = mirror[r][f"mirror{D}"]
        assert [row[:2] + row[3:] for row in other["rows"]] == \
            [row[:2] + row[3:] for row in got["rows"]]


@pytest.mark.parametrize("D", [2, 4])
def test_poison_flip_is_found_on_every_rank_and_repaired(mirror, D):
    for r in range(D):
        m = mirror[r][f"mirror{D}"]
        assert m["clean"] == []
        assert m["diverged"] == ["p_sign"]
        assert len(m["diffs"]) == 1 and "p_sign" in m["diffs"][0]
        assert m["repaired"] == []
