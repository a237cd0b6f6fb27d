"""The scan-CSR solve (ksched_tpu_torch/solver/csr_solver.py) against the
JAX package's (ksched_tpu/solver/jax_solver.py), bit for bit (tolerance
0: integer arithmetic): the plan, `_solve_mcmf` on seeded scheduling
graphs at eps 1 and cold with and without refitted potentials, and
CsrSolver against JaxSolver over warm-started rounds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ksched_tpu.solver import jax_solver as js
from ksched_tpu_torch import interop
from ksched_tpu_torch.solver import csr_solver as cs

from test_jax_solver import random_scheduling_problem
from test_solver_oracle import make_problem

PLAN_FIELDS = ("s_arc", "s_sign", "s_src", "s_dst", "s_segstart", "s_isstart",
               "inv_order", "node_first", "node_last", "node_nonempty")


def _port(jp):
    return interop.flow_problem(jp.num_nodes, jp.excess, jp.node_type, jp.src,
                                jp.dst, jp.cap, jp.cost, jp.flow_offset,
                                jp.num_arcs)


def _scaled(p):
    n = p.num_nodes
    return (p.cap.astype(np.int32), p.cost.astype(np.int32) * np.int32(n),
            p.excess.astype(np.int32))


def _both(p, flow0, eps, warm_p=None, max_supersteps=50_000):
    """One solve in each package on the same numpy inputs; returns the
    two results as tuples of numpy arrays."""
    src, dst = p.src.astype(np.int32), p.dst.astype(np.int32)
    plan = cs.build_csr_plan(src, dst, p.num_nodes)
    jplan = js.build_csr_plan(src, dst, p.num_nodes)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    cap, cost, supply = _scaled(p)
    jout = js._solve_mcmf(
        *(jnp.asarray(x) for x in (cap, cost, supply, flow0)),
        jnp.asarray(np.int32(eps)),
        *(jnp.asarray(getattr(jplan, f)) for f in PLAN_FIELDS),
        warm_p=None if warm_p is None else jnp.asarray(warm_p),
        use_warm_p=warm_p is not None, max_supersteps=max_supersteps,
    )
    tout = cs._solve_mcmf(
        *(torch.as_tensor(x) for x in (cap, cost, supply, flow0)), eps,
        *plan.tensors("cpu"),
        warm_p=None if warm_p is None else torch.as_tensor(np.array(warm_p)),
        use_warm_p=warm_p is not None, max_supersteps=max_supersteps,
    )
    return (tuple(np.asarray(x) for x in jout),
            tuple(x.numpy() for x in tout))


def _assert_same(jout, tout):
    names = ("flow", "p", "steps", "converged", "p_overflow")
    for name, a, b in zip(names, jout, tout):
        np.testing.assert_array_equal(b, a, err_msg=name)
        assert b.dtype == a.dtype or name in ("converged", "p_overflow"), name


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cold", [False, True])
def test_solve_mcmf_matches_jax(seed, cold):
    rng = np.random.default_rng(seed)
    p = random_scheduling_problem(rng, num_tasks=40, num_machines=4,
                                  slots_per_machine=3)
    n = p.num_nodes
    eps = max(1, int(np.abs(p.cost).max()) * n) if cold else 1
    jout, tout = _both(p, np.zeros(len(p.src), np.int32), eps)
    assert bool(jout[3])
    _assert_same(jout, tout)


@pytest.mark.parametrize("seed", range(3))
def test_solve_mcmf_warm_p_refit_matches_jax(seed):
    """The refit prologue: carried flow and potentials from one solve,
    then costs and supplies nudged, re-solved at eps 1 with warm_p."""
    rng = np.random.default_rng(10 + seed)
    p = random_scheduling_problem(rng, num_tasks=40, num_machines=4,
                                  slots_per_machine=3)
    jout, _ = _both(p, np.zeros(len(p.src), np.int32), 1)
    flow, pot = jout[0], jout[1]
    p.cost = p.cost.copy()
    hit = rng.choice(len(p.cost), 6, replace=False)
    p.cost[hit] = np.maximum(0, p.cost[hit] + rng.integers(-2, 3, 6))
    flow0 = np.minimum(flow, p.cap).astype(np.int32)
    jout2, tout2 = _both(p, flow0, 1, warm_p=pot)
    _assert_same(jout2, tout2)
    # a short budget that stops mid-discharge stops both at the same state
    jout3, tout3 = _both(p, flow0, 1, warm_p=pot, max_supersteps=3)
    _assert_same(jout3, tout3)


def test_segment_reductions_match_jax():
    rng = np.random.default_rng(4)
    p = random_scheduling_problem(rng, num_tasks=30, num_machines=3,
                                  slots_per_machine=2)
    plan = cs.build_csr_plan(p.src.astype(np.int32), p.dst.astype(np.int32),
                             p.num_nodes)
    vals = rng.integers(-1000, 1000, len(plan.s_arc)).astype(np.int32)
    t = plan.tensors("cpu")
    tv = torch.as_tensor(vals)
    j = [jnp.asarray(getattr(plan, f)) for f in PLAN_FIELDS]
    jv = jnp.asarray(vals)
    np.testing.assert_array_equal(
        cs._seg_sum(tv, t[7].long(), t[8].long(), t[9]).numpy(),
        np.asarray(js._seg_sum(jv, j[7], j[8], j[9])))
    for port, ref, ident in ((cs._seg_max, js._seg_max, -(1 << 30)),
                             (cs._seg_min, js._seg_min, 1 << 28)):
        np.testing.assert_array_equal(
            port(tv, t[5], t[8].long(), t[9], ident).numpy(),
            np.asarray(ref(jv, j[5], j[8], j[9], jnp.int32(ident))))


def _rounds(seed):
    """A warm-started round sequence on one random scheduling graph:
    the graph, costs nudged, supplies moved, an arc re-wired, then the
    first graph again."""
    rng = np.random.default_rng(seed)
    p0 = random_scheduling_problem(rng, num_tasks=24, num_machines=3,
                                   slots_per_machine=3)
    out = [p0]
    p1 = _copy(p0)
    hit = rng.choice(len(p1.cost), 5, replace=False)
    p1.cost[hit] += rng.integers(1, 4, 5).astype(p1.cost.dtype)
    out.append(p1)
    p2 = _copy(p1)
    tasks = np.nonzero(p2.excess > 0)[0]
    p2.excess[tasks[0]] = 0  # a task leaves: its unit goes unsent
    sink = int(np.argmin(p2.excess))
    p2.excess[sink] += 1
    out.append(p2)
    p3 = _copy(p2)
    a = int(np.nonzero(p3.src == tasks[1])[0][0])
    p3.dst[a] = p3.dst[int(np.nonzero(p3.src == tasks[2])[0][0])]
    out.append(p3)
    out.append(_copy(p0))
    return out


def _copy(p):
    from ksched_tpu.graph.device_export import FlowProblem

    return FlowProblem(
        num_nodes=p.num_nodes, excess=p.excess.copy(), node_type=p.node_type,
        src=p.src.copy(), dst=p.dst.copy(), cap=p.cap.copy(),
        cost=p.cost.copy(), flow_offset=p.flow_offset, num_arcs=p.num_arcs,
    )


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kw", [
    {}, {"journal_scoped_warm": False}, {"restart_budget": 2},
    {"warm_potentials": False},
], ids=["default", "unscoped", "restart_budget", "no_warm_p"])
def test_csr_solver_matches_jax_solver_over_rounds(seed, kw):
    jx = js.JaxSolver(slot_stable=False, **kw)
    port = cs.CsrSolver(device="cpu", **kw)
    for i, jp in enumerate(_rounds(seed)):
        want = jx.solve(jp)
        got = port.solve(_port(jp))
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        assert got.flow.dtype == want.flow.dtype
        assert (got.objective, got.iterations) == (want.objective, want.iterations)
        assert port.last_supersteps == jx.last_supersteps
        assert port.last_warm_scope == jx.last_warm_scope, i


def test_csr_solver_errors_match_jax_solver():
    """Infeasible supply stalls both (the cold attempt's budget spent),
    overflowing scaled costs raise OverflowError in both, and an
    arc-less problem with supply is refused by both."""
    from ksched_tpu.obs.soltel import SolverStallError as JStall
    from ksched_tpu_torch.solver.base import SolverStallError

    stuck = make_problem(4, {1: 2, 3: -2}, [(1, 2, 0, 1, 1), (2, 3, 0, 2, 1)])
    jx = js.JaxSolver(max_supersteps=300)
    port = cs.CsrSolver(max_supersteps=300, device="cpu")
    with pytest.raises(JStall):
        jx.solve(stuck)
    with pytest.raises(SolverStallError):
        port.solve(_port(stuck))
    assert port.last_supersteps == jx.last_supersteps
    big = make_problem(4, {1: 1, 3: -1}, [(1, 2, 0, 1, 1 << 28), (2, 3, 0, 1, 1)])
    for s, p in ((jx, big), (port, _port(big))):
        with pytest.raises(OverflowError):
            s.solve(p)
    empty = make_problem(3, {1: 1, 2: -1}, [])
    for s, p in ((jx, empty), (port, _port(empty))):
        with pytest.raises(RuntimeError, match="infeasible"):
            s.solve(p)


def test_telemetry_ring_is_not_ported():
    """The soltel telemetry ring, which this solve once refused, is now
    written: a ring that wraps (cap 8) equal to the JAX package's, bit
    for bit, with the flows unchanged; slot-stable plans are solved
    (tests/test_torch_csr_slot_stable.py)."""
    rng = np.random.default_rng(0)
    p = random_scheduling_problem(rng, num_tasks=6, num_machines=2,
                                  slots_per_machine=2)
    src, dst = p.src.astype(np.int32), p.dst.astype(np.int32)
    plan = cs.build_csr_plan(src, dst, p.num_nodes)
    jplan = js.build_csr_plan(src, dst, p.num_nodes)
    args = tuple(torch.as_tensor(x) for x in _scaled(p))
    f0 = torch.zeros(len(p.src), dtype=torch.int32)
    out = cs._solve_mcmf(*args, f0, 1, *plan.tensors("cpu"), slot_stable=True)
    assert bool(out[3])
    eps = max(1, int(np.abs(p.cost).max()) * p.num_nodes)
    got = cs._solve_mcmf(*args, f0, eps, *plan.tensors("cpu"), telemetry_cap=8)
    want = js._solve_mcmf(
        *(jnp.asarray(x) for x in _scaled(p)), jnp.asarray(f0.numpy()),
        jnp.asarray(np.int32(eps)),
        *(jnp.asarray(getattr(jplan, f)) for f in PLAN_FIELDS), telemetry_cap=8)
    assert int(got[2]) > 8  # the ring wrapped
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert got[5].dtype == torch.int32
    off = cs._solve_mcmf(*args, f0, eps, *plan.tensors("cpu"))
    for a, b in zip(got[:5], off):
        assert torch.equal(a, b)
