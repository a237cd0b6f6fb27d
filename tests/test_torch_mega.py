"""The general-graph kernel's path (ksched_tpu_torch/ops/mcmf.py and
solver/mega_solver.py) against the JAX package's (ops/mcmf_pallas.py,
solver/mega_solver.py), bit for bit (tolerance 0: integer arithmetic):
the MegaPlan tables, `mcmf_loop_plain` against the Pallas kernel run by
its interpreter and against the scan-CSR solve, MegaSolver against the
JAX MegaSolver over warm-started rounds, the `fits` refusals, the
dense -> mega -> csr ladder and make_backend("mega")'s delegation. The
JAX side's stand-in for the kernel (tests/torch_event_mega_reference.py)
is held equal to the interpreted kernel here too."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ksched_tpu.ops.mcmf_pallas import mcmf_loop_pallas
from ksched_tpu.solver import jax_solver as js
from ksched_tpu.solver import mega_solver as jm
from ksched_tpu_torch.ops import mcmf
from ksched_tpu_torch.solver import csr_solver as cs
from ksched_tpu_torch.solver import mega_solver as tm
from ksched_tpu_torch.solver.base import SolverStallError
from ksched_tpu_torch.solver.graph_collapse import AutoSolver
from ksched_tpu_torch.solver.select import make_backend

from test_jax_solver import random_scheduling_problem
from test_solver_oracle import make_problem
from test_torch_csr_solver import PLAN_FIELDS, _copy, _port, _scaled
from torch_event_mega_reference import mega_standin

MEGA_FIELDS = ("e_arc", "e_sign", "e_src", "e_hs", "e_he", "e_prow", "e_pcol",
               "fwd_pos")


def _problem(seed, tasks=40, machines=4, slots=3):
    return random_scheduling_problem(np.random.default_rng(seed), num_tasks=tasks,
                                     num_machines=machines, slots_per_machine=slots)


def _plans(p, lanes):
    src, dst = p.src.astype(np.int32), p.dst.astype(np.int32)
    jcsr = js.build_csr_plan(src, dst, p.num_nodes)
    return (jcsr, jm.build_mega_plan(jcsr, lanes),
            tm.build_mega_plan(cs.build_csr_plan(src, dst, p.num_nodes), lanes))


@pytest.mark.parametrize("lanes", [None, 8, 64])
def test_mega_plan_matches_jax(lanes):
    p = _problem(3)
    _jcsr, jplan, plan = _plans(p, lanes)
    assert (plan.R, plan.L) == (jplan.R, jplan.L)
    for f in MEGA_FIELDS + ("src", "dst"):
        a, b = getattr(plan, f), getattr(jplan, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.dtype == b.dtype, f


def _loop_inputs(p, lanes, flow0=None):
    """(arc and node arrays, entry tables, R, L) as numpy, the padding
    MegaSolver applies included."""
    _jcsr, _jplan, plan = _plans(p, lanes)
    cap, cost, supply = _scaled(p)
    m = len(p.src)
    f0 = np.zeros(m, np.int32) if flow0 is None else flow0
    arrays = [tm._pad_pow2(x) for x in (cap, cost, supply, f0)]
    tables = [getattr(plan, f) for f in MEGA_FIELDS[:-1]] + [tm._pad_pow2(plan.fwd_pos)]
    return arrays, tables, plan.R, plan.L


def _plain(arrays, tables, R, L, eps, **kw):
    a = [torch.as_tensor(x) for x in arrays]
    t = [torch.as_tensor(x) for x in tables]
    out = mcmf.mcmf_loop(*a, eps, *t, R, L, **kw)
    return tuple(np.asarray(x) for x in out)


def _jax(fn, arrays, tables, R, L, eps, **kw):
    out = fn(*(jnp.asarray(x) for x in arrays), jnp.asarray(np.int32(eps)),
             *(jnp.asarray(x) for x in tables), R=R, L=L, **kw)
    return tuple(np.asarray(x) for x in out)


def _assert_same(got, want, what):
    names = ("flow", "steps", "converged", "p_overflow")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


_INTERPRETED = {}


def _interpreted(lanes, cold):
    """The Pallas kernel under its interpreter on the 64-node graph of
    tests/test_mega_solver.py, computed once per case."""
    key = (lanes, cold)
    if key not in _INTERPRETED:
        p = _problem(7)
        arrays, tables, R, L = _loop_inputs(p, lanes)
        eps = max(1, int(np.abs(p.cost).max()) * p.num_nodes) if cold else 1
        want = _jax(mcmf_loop_pallas, arrays, tables, R, L, eps, interpret=True)
        _INTERPRETED[key] = (arrays, tables, R, L, eps, want)
    return _INTERPRETED[key]


@pytest.mark.parametrize("lanes", [None, 8])
@pytest.mark.parametrize("cold", [False, True], ids=["eps1", "cold"])
def test_plain_matches_interpreted_kernel(lanes, cold):
    arrays, tables, R, L, eps, want = _interpreted(lanes, cold)
    if lanes is not None:
        assert R > 1  # the cross-row carry of the Pallas scans is live
    assert bool(want[2]) and not bool(want[3])
    _assert_same(_plain(arrays, tables, R, L, eps), want, "plain")


@pytest.mark.parametrize("lanes", [None, 8])
@pytest.mark.parametrize("cold", [False, True], ids=["eps1", "cold"])
def test_standin_matches_interpreted_kernel(lanes, cold):
    """The stand-in returns zeros past the M real arcs, where the kernel
    returns the flow at the padded forward positions (entry 0's), which
    MegaSolver drops."""
    arrays, tables, R, L, eps, want = _interpreted(lanes, cold)
    got = _jax(mega_standin, arrays, tables, R, L, eps)
    m = int((tables[1] != 0).sum()) // 2
    _assert_same((got[0][:m],) + got[1:], (want[0][:m],) + want[1:], "stand-in")


def _csr_solve(p, flow0, eps, max_supersteps):
    """JAX `_solve_mcmf`'s (flow, steps, converged, p_overflow)."""
    jcsr = js.build_csr_plan(p.src.astype(np.int32), p.dst.astype(np.int32),
                             p.num_nodes)
    out = js._solve_mcmf(*(jnp.asarray(x) for x in (*_scaled(p), flow0)),
                         jnp.asarray(np.int32(eps)),
                         *(jnp.asarray(getattr(jcsr, f)) for f in PLAN_FIELDS),
                         max_supersteps=max_supersteps)
    flow, _p, steps, conv, povf = (np.asarray(x) for x in out)
    return flow, steps, conv, povf


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("lanes", [None, 8])
@pytest.mark.parametrize("budget", [50_000, 5], ids=["full", "cut"])
def test_plain_matches_csr_solve(seed, lanes, budget):
    """mcmf_loop_plain against JAX's scan-CSR `_solve_mcmf` (which the
    Pallas kernel equals bit for bit) on seeded graphs: eps 1 and cold,
    from zero and from a carried flow, and stopped after 5 supersteps,
    where both must hold the same state. Seed 1's entries fill the
    [R, 512] tiling less than the others: its pad segment is long."""
    p = _problem(20 + seed, tasks=10 + 25 * seed, machines=2 + seed)
    m = len(p.src)
    # a carried flow: the optimum with a tenth of its arcs emptied
    warm = _csr_solve(p, np.zeros(m, np.int32), 1, 50_000)[0].copy()
    warm[np.random.default_rng(seed).choice(m, m // 10, replace=False)] = 0
    for flow0 in (np.zeros(m, np.int32), warm):
        for eps in (1, max(1, int(np.abs(p.cost).max()) * p.num_nodes)):
            arrays, tables, R, L = _loop_inputs(p, lanes, flow0)
            got = _plain(arrays, tables, R, L, eps, max_supersteps=budget)
            flow, steps, conv, povf = _csr_solve(p, flow0, eps, budget)
            np.testing.assert_array_equal(got[0][:m], flow)
            assert (int(got[1]), bool(got[2]), bool(got[3])) == (
                int(steps), bool(conv), bool(povf))


def _rounds(seed):
    """Warm-started rounds: costs nudged, a supply moved, an arc
    re-wired, then the first graph again."""
    rng = np.random.default_rng(seed)
    p0 = random_scheduling_problem(rng, num_tasks=12, num_machines=3,
                                   slots_per_machine=2)
    p1 = _copy(p0)
    p1.cost[0] += 2
    p2 = _copy(p1)
    tasks = np.nonzero(p2.excess > 0)[0]
    p2.excess[tasks[0]] = 0
    p2.excess[int(np.argmin(p2.excess))] += 1
    p3 = _copy(p2)
    a = int(np.nonzero(p3.src == tasks[1])[0][0])
    p3.dst[a] = p3.dst[int(np.nonzero(p3.src == tasks[2])[0][0])]
    return [p0, p1, p2, p3, _copy(p0)]


def test_mega_solver_matches_jax_mega_solver_over_rounds():
    jx = jm.MegaSolver(interpret=True, telemetry=0)
    port = tm.MegaSolver(device="cpu")
    for i, jp in enumerate(_rounds(5)):
        want = jx.solve(jp)
        got = port.solve(_port(jp))
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        assert got.flow.dtype == want.flow.dtype
        assert (got.objective, got.iterations) == (want.objective, want.iterations)
        assert port.last_supersteps == jx.last_supersteps


def test_mega_solver_matches_csr_solver_over_rounds():
    """Eight rounds of the port alone: MegaSolver's flows equal a
    CsrSolver run with MegaSolver's warm policy (no journal scoping,
    no carried potentials), round after round."""
    port = tm.MegaSolver(device="cpu")
    csr = cs.CsrSolver(device="cpu", journal_scoped_warm=False,
                       warm_potentials=False)
    for i, jp in enumerate(_rounds(6) + _rounds(7)[1:4]):
        p = _port(jp)
        got, want = port.solve(p), csr.solve(p)
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        assert got.objective == want.objective


def _ladder_problem():
    """Untyped nodes: the collapse audit refuses, the general path runs."""
    return make_problem(
        8, {1: 1, 2: 1, 6: -2},
        [(1, 3, 0, 1, 2), (2, 3, 0, 1, 2), (3, 4, 0, 1, 0), (3, 5, 0, 1, 4),
         (4, 6, 0, 1, 0), (5, 6, 0, 1, 0), (1, 7, 0, 1, 50), (2, 7, 0, 1, 50),
         (7, 6, 0, 2, 0)],
    )


@pytest.mark.parametrize("case", ["budget", "overflow", "isolated", "empty"])
def test_fits_refusals_match_jax(case):
    """Each refusal of the JAX MegaSolver's `fits` is the port's too,
    with the same reason (the budget named for the card's L2)."""
    jx = jm.MegaSolver(interpret=True, telemetry=0)
    port = tm.MegaSolver(device="cpu")
    p = _ladder_problem()
    if case == "budget":
        jx.vmem_budget_bytes = port.budget_bytes = 64
    elif case == "overflow":
        p = make_problem(4, {1: 1, 3: -1}, [(1, 2, 0, 1, 1 << 28), (2, 3, 0, 1, 1)])
    elif case == "isolated":
        p = make_problem(6, {1: 1, 3: -1, 5: 2}, [(1, 2, 0, 1, 1), (2, 3, 0, 1, 1)])
    else:
        p = make_problem(4, {}, [])
    assert not jx.fits(p) and not port.fits(_port(p))
    want = {"budget": "L2 budget", "overflow": "overflow",
            "isolated": "isolated node", "empty": "empty graph"}[case]
    assert want in port.last_refusal
    if case != "budget":
        assert port.last_refusal == jx.last_refusal
    ok = _ladder_problem()
    assert jm.MegaSolver(interpret=True, telemetry=0).fits(ok)
    assert tm.MegaSolver(device="cpu").fits(_port(ok))


def test_mega_budget_gate():
    """The card's gate: 21 int32 tables of the padded entry count (and a
    few words per block) within the budget; the 10k x 1k shape (R =
    256) fits."""
    assert mcmf.mega_entry_rows(131_072) == 256
    assert mcmf.mega_fits(131_072)
    assert mcmf.MEGA_LIVE_TABLES * 131_072 * 4 <= mcmf.MEGA_BUDGET_BYTES
    limit = mcmf.MEGA_BUDGET_BYTES // (mcmf.MEGA_LIVE_TABLES * 4 * mcmf.MEGA_LANES)
    assert mcmf.mega_fits(limit * mcmf.MEGA_LANES)
    assert not mcmf.mega_fits(limit * mcmf.MEGA_LANES + 1)


def test_autosolver_escalates_dense_mega_csr():
    """A non-collapsible graph inside the budget takes the mega rung;
    with the budget shrunk it falls through to the CSR rung; without a
    mega rung the refusal is named; the JAX ladder agrees."""
    from ksched_tpu.solver.graph_collapse import AutoSolver as JAuto
    from ksched_tpu.solver.cpu_ref import ReferenceSolver as JRef

    p = _ladder_problem()
    tp = _port(p)
    want = JRef().solve(p).objective

    jauto = JAuto(js.JaxSolver(), mega=jm.MegaSolver(interpret=True, telemetry=0))
    jres = jauto.solve(p)
    auto = AutoSolver(cs.CsrSolver(device="cpu"),
                      mega=tm.MegaSolver(device="cpu"), device="cpu")
    res = auto.solve(tp)
    assert auto.last_path == jauto.last_path == "mega"
    assert res.objective == jres.objective == want
    np.testing.assert_array_equal(res.flow, jres.flow)
    assert auto.last_supersteps == jauto.last_supersteps
    assert auto.last_mega_refusal == ""

    tiny = AutoSolver(cs.CsrSolver(device="cpu"),
                      mega=tm.MegaSolver(device="cpu", budget_bytes=64), device="cpu")
    res2 = tiny.solve(tp)
    assert tiny.last_path == "csr" and "budget" in tiny.last_mega_refusal
    assert res2.objective == want

    no_mega = AutoSolver(cs.CsrSolver(device="cpu"), device="cpu")
    assert no_mega.solve(tp).objective == want
    assert no_mega.last_path == "csr"
    assert no_mega.last_mega_refusal == "no megakernel attached"

    # a collapsible graph still takes the dense transport
    rng = np.random.default_rng(0)
    from ksched_tpu_torch.drivers import build_cluster, add_job

    sched, _r, jmap, tmap, _root = build_cluster(
        num_machines=3, num_cores=1, pus_per_core=2, max_tasks_per_pu=1,
        backend=make_backend("auto", device="cpu"))
    add_job(sched, jmap, tmap, num_tasks=int(rng.integers(3, 6)))
    sched.schedule_all_jobs()
    assert sched.solver.backend.last_path == "dense"
    assert sched.solver.backend.last_mega_refusal == ""


def test_make_backend_mega_delegates_to_csr():
    """make_backend("mega") is total: a graph the kernel refuses goes
    to its CsrSolver fallback with the same result; without a
    fallback the refusal raises."""
    p = _port(_problem(2, tasks=12, machines=3, slots=2))
    mg = make_backend("mega", device="cpu")
    assert isinstance(mg, tm.MegaSolver) and isinstance(mg.fallback, cs.CsrSolver)
    want = cs.CsrSolver(device="cpu").solve(p).objective
    assert mg.solve(p).objective == want
    mg.budget_bytes = 64  # force the delegation
    assert not mg.fits(p)
    mg.reset()
    res = mg.solve(p)
    assert res.objective == want
    assert mg.last_supersteps == mg.fallback.last_supersteps
    bare = tm.MegaSolver(device="cpu", budget_bytes=64)
    with pytest.raises(RuntimeError, match="L2 budget"):
        bare.solve(p)
    assert isinstance(make_backend("jax", device="cpu"), cs.CsrSolver)
    auto = make_backend("auto", device="cpu")
    assert isinstance(auto.csr, cs.CsrSolver) and isinstance(auto.mega, tm.MegaSolver)


def test_mega_solver_stall_and_overflow_match_jax():
    """An infeasible supply stalls both MegaSolvers after the same
    supersteps of the cold attempt."""
    from ksched_tpu.obs.soltel import SolverStallError as JStall

    stuck = make_problem(4, {1: 2, 3: -2}, [(1, 2, 0, 1, 1), (2, 3, 0, 2, 1)])
    jx = jm.MegaSolver(interpret=True, telemetry=0, max_supersteps=40)
    port = tm.MegaSolver(device="cpu", max_supersteps=40)
    with pytest.raises(JStall):
        jx.solve(stuck)
    with pytest.raises(SolverStallError):
        port.solve(_port(stuck))
    assert port.last_supersteps == jx.last_supersteps == 40


def test_mcmf_loop_refuses_other_devices():
    p = _problem(1, tasks=6, machines=2, slots=2)
    arrays, tables, R, L = _loop_inputs(p, None)
    a = [torch.as_tensor(x).to("meta") for x in arrays]
    t = [torch.as_tensor(x) for x in tables]
    with pytest.raises(ValueError, match="cuda or cpu"):
        mcmf.mcmf_loop(*a, 1, *t, R, L)


@pytest.mark.parametrize("seed", range(3))
def test_random_flow_problem_matches_jax_test_graphs(seed):
    """The port's seeded graph generator (used on the card, where the
    JAX tests' helpers cannot be imported) draws the same graphs."""
    from ksched_tpu_torch.drivers import random_flow_problem

    kw = dict(num_tasks=15 + seed, num_machines=2 + seed, slots_per_machine=2)
    want = random_scheduling_problem(np.random.default_rng(seed), **kw)
    got = random_flow_problem(np.random.default_rng(seed), **kw)
    for f in ("num_nodes", "num_arcs"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("excess", "src", "dst", "cap", "cost", "flow_offset"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    padded = random_flow_problem(np.random.default_rng(seed), arc_slots=256, **kw)
    assert len(padded.src) == 256 and padded.num_arcs == want.num_arcs
    assert not padded.cap[want.num_arcs:].any()
    res = tm.MegaSolver(device="cpu").solve(padded)
    assert res.objective == cs.CsrSolver(device="cpu").solve(_port(want)).objective
