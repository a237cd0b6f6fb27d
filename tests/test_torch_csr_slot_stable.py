"""The slot-stable CSR solve, port against the JAX package, bit for bit
(tolerance 0: integer arithmetic).

- `_solve_mcmf(slot_stable=True)` on the same maintained plan tensors
  (graph/slot_plan.py, taken from a churned DeviceGraphState, dead rows
  and relocated regions included), at eps 1, cold and with refitted
  potentials: flows, potentials, supersteps, convergence;
- the port's default CsrSolver against the JAX package's default
  JaxSolver() (both slot-stable) over a small churn scenario of the
  `churn` config's kind (400 tasks on 40 machines x 4 PUs x 4 slots,
  20 tasks completed and 20 added a round, restart budget 64): per round
  supersteps, warm scope and the placements' sha256. The port's CSR
  rung once solved on the argsort plan only, which places differently
  from round 1 on."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ksched_tpu.solver import jax_solver as js
from ksched_tpu_torch.drivers.churn import ChurnArm
from ksched_tpu_torch.solver import csr_solver as cs
from ksched_tpu_torch.solver.csr_solver import CsrSolver

from torch_churn_reference import JaxChurnArm
from torch_plan_twin import SCRIPT, Pair, churn_round


def _plan_cases():
    """(problem, plan host arrays) at three points of a churned plan."""
    pair = Pair(24, 5)
    rng = np.random.default_rng(7)
    pair.solve_round("round 0")
    out = []
    for rnd, kind in enumerate(SCRIPT, 1):
        churn_round(pair, kind, rng)
        pair.solve_round(f"round {rnd}")
        if rnd in (2, 5, 9):
            out.append((pair.j.problem(), tuple(x.copy() for x in pair.j.plan.host_args())))
    return out


@pytest.fixture(scope="module")
def plan_cases():
    return _plan_cases()


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("mode", ["eps1", "cold", "warm_p"])
def test_slot_stable_solve_matches_jax(plan_cases, case, mode):
    p, plan = plan_cases[case]
    p_sign = plan[1]
    assert (p_sign == 0).sum() > 1  # dead rows beside the reserved one
    n = p.num_nodes
    cap = p.cap.astype(np.int32)
    cost = p.cost.astype(np.int32) * np.int32(n)
    supply = p.excess.astype(np.int32)
    flow0 = np.zeros(len(cap), np.int32)
    eps = max(1, int(np.abs(p.cost).max()) * n) if mode == "cold" else 1
    warm_p = None
    if mode == "warm_p":
        first = js._solve_mcmf(*(jnp.asarray(x) for x in (cap, cost, supply, flow0)),
                               jnp.asarray(np.int32(1)),
                               *(jnp.asarray(x) for x in plan), slot_stable=True)
        flow0 = np.minimum(np.asarray(first[0]), cap).astype(np.int32)
        warm_p = np.array(first[1])
        cost = cost.copy()
        cost[np.flatnonzero(cap)[:5]] += np.int32(n)  # nudge a few costs
    jout = js._solve_mcmf(
        *(jnp.asarray(x) for x in (cap, cost, supply, flow0)), jnp.asarray(np.int32(eps)),
        *(jnp.asarray(x) for x in plan),
        warm_p=None if warm_p is None else jnp.asarray(warm_p),
        use_warm_p=warm_p is not None, slot_stable=True)
    tout = cs._solve_mcmf(
        *(torch.as_tensor(x) for x in (cap, cost, supply, flow0)), eps,
        *(torch.as_tensor(x) for x in plan),
        warm_p=None if warm_p is None else torch.as_tensor(warm_p),
        use_warm_p=warm_p is not None, slot_stable=True)
    assert bool(jout[3])
    for name, a, b in zip(("flow", "p", "steps", "converged", "p_overflow"),
                          jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert tout[0].dtype == torch.int32 and tout[1].dtype == torch.int32


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_default_csr_solver_places_like_default_jax_solver(resident):
    """Per round: supersteps, warm scope and placements equal. On the
    argsort plan the port's supersteps were 10, 10, 10, 11, ... where
    the JAX package's are 10, 9, 9, 9, ... and the placements differ
    from round 1 on."""
    kw = dict(tasks=400, machines=40, churn=0.05)
    jarm = JaxChurnArm(**kw, resident=resident)
    assert type(jarm.solver) is js.JaxSolver and jarm.solver.slot_stable
    tarm = ChurnArm("device_resident" if resident else "delta_scatter", device="cpu", **kw)
    assert type(tarm.solver) is CsrSolver
    assert tarm.fill_supersteps == jarm.fill_supersteps
    for r in range(8):
        want, got = jarm.drive_round(r), tarm.drive_round(r)
        for key in ("supersteps", "warm_scope", "sha256"):
            assert got[key] == want[key], f"round {r}: {key}"
        if resident:
            assert (got["plan_kind"], got["upload_bytes"]) == (
                want["plan_kind"], want["upload_bytes"]), f"round {r}"
