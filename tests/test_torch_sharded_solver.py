"""The port's sharded scan-CSR solve (ksched_tpu_torch/parallel/
sharded_solver.py) on gloo ranks on the CPU against the JAX package's,
tolerance 0: at D = 2 against its ShardedJaxSolver on the conftest's
virtual 2-device mesh, at D = 4 against its single-device JaxSolver
(slot-stable; its own tests hold the two equal at any D) or, on the
legacy path, its ShardedJaxSolver on 4 virtual devices.

- slot-stable rounds over the churn script (flows, supersteps,
  objective, warm scope, carried potentials), with the plan's own
  upload and on the sharded resident mirror (delta-sized rounds, psum'd
  fingerprints), and the single-device CsrSolver on a sharded mirror;
- the legacy argsort path with a warm re-solve; soltel rings on both
  paths, global on every rank;
- the fitting gate's arithmetic, AutoSolver's escalation (lazily, once)
  exactly where the JAX package's gate escalates, the ladder's
  sharded -> jax step, make_backend("sharded"/"auto") on a group;
- bench.py's gtrace100k driver (drivers/sharded_scale.py) at a test
  size, both arms, every round's record against the JAX package's twin
  (tests/torch_parallel_reference.py).

One spawn of 4 ranks runs every rank-side case (ksched_tpu_torch/parallel/launch.py)."""

import numpy as np
import pytest

from ksched_tpu_torch.parallel.launch import run_ranks
from torch_parallel_cases import DRIVE, SCALE, legacy_rngs, legacy_shape

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("torch_parallel_cases:solver_cases", WORLD, deadline_s=300)


def _mesh(D):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:D]), ("x",))


def _jax_drive(make_solver, resident=False, mesh=None, rounds=DRIVE["rounds"]):
    """tests/torch_parallel_cases.drive_rounds on the JAX package."""
    from ksched_tpu.graph.device_export import DeviceResidentState

    from torch_plan_twin import SCRIPT, JSolo, churn_round

    solo = JSolo(DRIVE["tasks"], DRIVE["machines"], machine_cap=DRIVE["machine_cap"])
    st = solo.j
    res = DeviceResidentState(st) if resident else None
    if mesh is not None:
        res.enable_sharded_plan(mesh, "x")
    solver = make_solver()
    rng = np.random.default_rng(7)
    rows = []
    for rnd in range(rounds + 1):
        if rnd:
            churn_round(solo, SCRIPT[(rnd - 1) % len(SCRIPT)], rng)
        prob = res.refresh() if resident else st.problem()
        r = solver.solve(prob)
        p = getattr(solver, "_prev_p", None)
        rows.append((np.asarray(r.flow).copy(), int(solver.last_supersteps),
                     int(r.objective), solver.last_warm_scope,
                     res.last_plan_kind if res is not None else None,
                     None if p is None else np.asarray(p)))
    return rows, st, res, solver


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for rnd, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"round {rnd} flow")
        assert g[1:5] == w[1:5], (rnd, g[1:5], w[1:5])
        if w[5] is not None:
            np.testing.assert_array_equal(g[5], w[5], err_msg=f"round {rnd} potentials")
            assert g[5].dtype == w[5].dtype


def _jax_single():
    from ksched_tpu.solver.jax_solver import JaxSolver

    return JaxSolver(slot_stable=True, restart_budget=64)


def _jax_reference_solver(D, **kw):
    from ksched_tpu.parallel.sharded_solver import ShardedJaxSolver

    if D == 2:
        return ShardedJaxSolver(_mesh(2), **kw)
    return _jax_single() if not kw else ShardedJaxSolver(_mesh(D), **kw)


@pytest.mark.parametrize("D", [2, 4])
def test_slot_stable_rounds_match_the_jax_package(ranks, D):
    rows, path = ranks[0][f"slot{D}"]
    assert path == "slot_stable"
    want, *_ = _jax_drive(lambda: _jax_reference_solver(D))
    _assert_rows_equal(rows, want)
    for r in range(1, D):
        _assert_rows_equal(ranks[r][f"slot{D}"][0], want)


def test_resident_sharded_rounds_are_delta_sized(ranks):
    rows, fps_ok, shape, es = ranks[0]["resident2"]
    want, *_ = _jax_drive(_jax_single, resident=True)
    # the plan kinds differ from a single-device mirror's only in being
    # the sharded one's; flows, supersteps, objectives and scopes match
    _assert_rows_equal([r[:4] + (None, r[5]) for r in rows],
                       [w[:4] + (None, w[5]) for w in want])
    jrows, *_ = _jax_drive(lambda: _jax_reference_solver(2), resident=True, mesh=_mesh(2))
    _assert_rows_equal(rows, jrows)
    kinds = [r[4] for r in rows]
    assert kinds.count("rebuild") == 1 and kinds.count("delta") >= 3, kinds
    assert all(fps_ok)
    assert shape == (es,)  # each rank holds its own [Es] block


def test_single_device_solver_consumes_a_sharded_mirror(ranks):
    """The ladder's jax rung (and AutoSolver's too-big-per-shard CSR
    fallback) solves a problem whose mirror is sharded: it uploads the
    host plan, and its rounds equal the JAX package's."""
    rows = ranks[0]["csr_on_sharded_mirror2"]
    want, *_ = _jax_drive(_jax_single, resident=True, mesh=_mesh(2))
    _assert_rows_equal(rows, want)


@pytest.mark.parametrize("D", [2, 4])
def test_legacy_path_matches_the_jax_package(ranks, D):
    from ksched_tpu.parallel.sharded_solver import ShardedJaxSolver as JSharded

    from test_jax_solver import random_scheduling_problem

    got = ranks[0][f"legacy{D}"]
    js = JSharded(_mesh(D))
    for i, rng in enumerate(legacy_rngs()):
        p = random_scheduling_problem(rng, *legacy_shape(rng))
        r1 = js.solve(p)
        s1 = js.last_supersteps
        p.cost = p.cost.copy()
        p.cost[0] += 3
        r2 = js.solve(p)
        f1, o1, g1, f2, o2, g2, path = got[i]
        np.testing.assert_array_equal(f1, r1.flow)
        np.testing.assert_array_equal(f2, r2.flow)
        assert (o1, g1, o2, g2, path) == (r1.objective, s1, r2.objective,
                                          js.last_supersteps, "legacy")
    for r in range(1, D):
        for a, b in zip(ranks[r][f"legacy{D}"], got):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:3] == b[1:3]


@pytest.mark.parametrize("D", [2, 4])
def test_rings_are_global_and_match_the_jax_package(ranks, D):
    from ksched_tpu.parallel.sharded_solver import ShardedJaxSolver as JSharded

    from test_jax_solver import random_scheduling_problem

    got = ranks[0][f"ring{D}"]
    rng = legacy_rngs()[0]
    p = random_scheduling_problem(rng, *legacy_shape(rng))
    js = JSharded(_mesh(D), telemetry=64)
    js.solve(p)
    assert got[0] == js.last_telemetry.to_dict()
    _rows, _st, _res, jst = _jax_drive(lambda: JSharded(_mesh(D), telemetry=64), rounds=1)
    assert got[1] == jst.last_telemetry.to_dict()
    for r in range(1, D):
        assert ranks[r][f"ring{D}"] == got


@pytest.mark.parametrize("n_cap,m_cap,D,budget", [
    (64, 256, 2, None), (1 << 10, 1 << 12, 4, 1 << 20), (1 << 17, 1 << 22, 8, 1 << 20),
    (16384, 65536, 2, 7602176), (1 << 14, 1 << 15, 8, 1 << 30)])
def test_gate_arithmetic_matches_the_jax_package(n_cap, m_cap, D, budget):
    import ksched_tpu.parallel.sharded_solver as J

    import ksched_tpu_torch.parallel.sharded_solver as T

    kw = {} if budget is None else {"budget_bytes": budget}
    assert T.DEFAULT_HBM_BUDGET_BYTES == J.DEFAULT_HBM_BUDGET_BYTES
    assert T.csr_working_set_bytes(n_cap, m_cap) == J.csr_working_set_bytes(n_cap, m_cap)
    assert T.sharded_shard_bytes(n_cap, m_cap, D) == J.sharded_shard_bytes(n_cap, m_cap, D)
    assert T.sharded_entry_extent(m_cap, D) == J.sharded_entry_extent(m_cap, D)
    assert T.scan_csr_fits_hbm(n_cap, m_cap, **kw) == J.scan_csr_fits_hbm(n_cap, m_cap, **kw)
    assert (T.sharded_fits_hbm(n_cap, m_cap, D, **kw)
            == J.sharded_fits_hbm(n_cap, m_cap, D, **kw))


def test_autosolver_escalates_exactly_where_the_jax_gate_does(ranks):
    from ksched_tpu.parallel.sharded_solver import ShardedJaxSolver as JSharded
    from ksched_tpu.solver.graph_collapse import AutoSolver as JAuto
    from ksched_tpu.solver.jax_solver import JaxSolver

    from torch_plan_twin import JSolo

    base_path, base_flow, path, flow, made, default_path, budget = ranks[0]["gate2"]
    solo = JSolo(DRIVE["tasks"], DRIVE["machines"], machine_cap=DRIVE["machine_cap"])
    jbase = JAuto(JaxSolver(slot_stable=True))
    jb = jbase.solve(solo.j.problem())
    jauto = JAuto(JaxSolver(slot_stable=True), sharded=lambda: JSharded(_mesh(2)),
                  hbm_budget_bytes=budget)
    jr = jauto.solve(solo.j.problem())
    jdefault = JAuto(JaxSolver(slot_stable=True), sharded=lambda: JSharded(_mesh(2)))
    jdefault.solve(solo.j.problem())
    assert (base_path, path, default_path) == (jbase.last_path, jauto.last_path,
                                               jdefault.last_path) == ("csr", "sharded", "csr")
    assert made == 1  # the factory resolved lazily, exactly once
    np.testing.assert_array_equal(flow, jr.flow)
    np.testing.assert_array_equal(base_flow, jb.flow)
    np.testing.assert_array_equal(flow, base_flow)


def test_ladder_steps_down_from_sharded_to_jax(ranks):
    names, first, second, o1, o2 = ranks[0]["ladder2"]
    assert names == ["sharded", "jax", "cpu_ref"]
    assert (first, second) == ("jax", "sharded")
    assert o1 == o2
    assert ranks[1]["ladder2"] == ranks[0]["ladder2"]


def test_make_backend_on_the_default_group(ranks):
    for r in range(WORLD):
        assert ranks[r]["backends"] == ("ShardedJaxSolver", WORLD, True,
                                        "ShardedJaxSolver", WORLD)


def test_make_backend_sharded_needs_a_group(monkeypatch):
    from ksched_tpu_torch.solver.graph_collapse import AutoSolver
    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.solver.select import make_backend

    with pytest.raises(RuntimeError, match="process group"):
        make_backend("sharded", device="cpu")
    assert make_backend("auto", device="cpu")._sharded is None  # one process
    monkeypatch.setenv("KSCHED_HBM_BUDGET", "12345")
    assert AutoSolver(CsrSolver(device="cpu"), device="cpu").hbm_budget_bytes == 12345


def test_scale_driver_matches_the_jax_package(ranks):
    from ksched_tpu_torch.drivers.sharded_scale import COMPARED

    from torch_parallel_reference import sharded_reference

    got = ranks[0]["scale2"]
    want = sharded_reference(devices=2, **SCALE)
    assert got["budget"] == want["budget"]
    assert got["bucket"] == want["bucket"]
    for arm in ("scan_csr", "sharded"):
        rows = [{f: rec[f] for f in COMPARED} for rec in got["arms"][arm]]
        assert rows == want["arms"][arm], arm
    measured = got["arms"]["sharded"][SCALE["warmup"]:]
    assert all(rec["path"] == "sharded" for rec in measured)
    # three psums a superstep, the JAX program's budget: the loop's
    # excess test and the superstep's arc deltas and potentials
    steps = got["measured_supersteps"]
    sites = got["collectives"]
    assert sites["superstep"] == {"psum": 2 * steps}
    assert sites["loop"]["psum"] > steps  # + one per phase change and exit
    assert sites["sweep"].keys() == {"pmin"} and sites["phase"].keys() == {"pmax"}
    assert [r["sha256"] for r in ranks[1]["scale2"]["arms"]["sharded"]] == \
        [r["sha256"] for r in got["arms"]["sharded"]]
