"""The bucketed-ELL solve (ksched_tpu_torch/solver/ell_solver.py, "ell")
against the JAX package's (ksched_tpu/solver/ell_solver.py), bit for bit
(tolerance 0: integer arithmetic): the plan at hub widths that split
hubs over rows, `_solve_mcmf_ell` at eps 1 and cold, EllSolver over
warm-started rounds, and on the device-resident export of the churn
scenario (a warm flow carried on the device), with make_backend("ell")
on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ksched_tpu.solver import ell_solver as je
from ksched_tpu_torch.drivers.churn import ChurnArm
from ksched_tpu_torch.solver import ell_solver as te
from ksched_tpu_torch.solver.select import make_backend

from test_jax_solver import random_scheduling_problem
from test_torch_csr_solver import _port, _rounds
from torch_churn_reference import JaxChurnArm

PLAN_FIELDS = ("s_node", "s_arc", "s_sign", "s_peer", "h_node", "h_arc", "h_sign",
               "h_peer", "h_rowhub", "h_rowk", "hub_rows", "hub_rows_valid",
               "hub_node", "node_kind", "node_slot", "fwd_flat", "bwd_flat", "src", "dst")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("w_hub", [512, 8])
@pytest.mark.parametrize("cold", [False, True])
def test_solve_matches_jax(seed, w_hub, cold):
    rng = np.random.default_rng(seed)
    p = random_scheduling_problem(rng, num_tasks=40, num_machines=4, slots_per_machine=3)
    n = p.num_nodes
    src, dst = p.src.astype(np.int32), p.dst.astype(np.int32)
    jplan = je.build_ell_plan(src, dst, n, w_small=4, w_hub=w_hub)
    tplan = te.build_ell_plan(src, dst, n, w_small=4, w_hub=w_hub)
    for f in PLAN_FIELDS:
        a, b = getattr(jplan, f), getattr(tplan, f)
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert w_hub == 512 or (tplan.h_rowk > 0).any()  # a hub over several rows
    cap = p.cap.astype(np.int32)
    cost = p.cost.astype(np.int32) * np.int32(n)
    supply = p.excess.astype(np.int32)
    flow0 = np.zeros(len(cap), np.int32)
    eps = max(1, int(np.abs(p.cost).max()) * n) if cold else 1
    jout = je._solve_mcmf_ell(*(jnp.asarray(x) for x in (cap, cost, supply, flow0)),
                              jnp.asarray(np.int32(eps)), *je._plan_args(jplan))
    tout = te._solve_mcmf_ell(*(torch.as_tensor(x) for x in (cap, cost, supply, flow0)),
                              eps, *te.plan_tensors(tplan, "cpu"))
    assert bool(jout[3])
    for name, a, b in zip(("flow", "p", "steps", "converged", "p_overflow"), jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("seed", range(2))
def test_ell_solver_matches_jax_over_rounds(seed):
    jx = je.EllSolver(telemetry=0)
    port = make_backend("ell", device="cpu")
    assert isinstance(port, te.EllSolver)
    for i, jp in enumerate(_rounds(seed)):
        want, got = jx.solve(jp), port.solve(_port(jp))
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        assert (got.objective, got.iterations) == (want.objective, want.iterations)
        assert port.last_supersteps == jx.last_supersteps


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_ell_churn_rounds_match_jax(resident):
    kw = dict(tasks=400, machines=40, churn=0.05)
    jarm = JaxChurnArm(**kw, backend=je.EllSolver(telemetry=0), resident=resident)
    tarm = ChurnArm("device_resident" if resident else "delta_scatter",
                    backend=make_backend("ell", device="cpu"), **kw)
    assert tarm.fill_supersteps == jarm.fill_supersteps
    for r in range(4):
        want, got = jarm.drive_round(r), tarm.drive_round(r)
        assert (got["supersteps"], got["sha256"]) == (want["supersteps"], want["sha256"]), r
    if resident:
        assert tarm.solver._prev_dev is not None  # the warm flow stayed on the device
        tarm.sched.solver.resident.parity_check()


def test_ell_solver_errors_match_jax():
    """Infeasible supply stalls both (the cold attempt's budget spent),
    overflowing scaled costs raise OverflowError in both, and an
    arc-less problem with supply is refused by both."""
    from ksched_tpu.obs.soltel import SolverStallError as JStall
    from ksched_tpu_torch.solver.base import SolverStallError
    from test_solver_oracle import make_problem

    stuck = make_problem(4, {1: 2, 3: -2}, [(1, 2, 0, 1, 1), (2, 3, 0, 2, 1)])
    jx = je.EllSolver(max_supersteps=300, telemetry=0)
    port = te.EllSolver(max_supersteps=300, device="cpu")
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
