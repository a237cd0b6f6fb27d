"""The port's C++ native solver (ksched_tpu_torch/native, built with g++
from its own copy of mcmf.cpp; solver/native.py NativeSolver) against
the JAX package's NativeSolver on the same problems: flows, objective
and iteration counts equal (tolerance 0), warm starts across rounds and
the error codes too; make_backend("native") with and without its
fallback."""

import dataclasses
import warnings

import numpy as np
import pytest

from ksched_tpu.graph.device_export import FlowProblem as JaxProblem
from ksched_tpu.solver.native import NativeSolver as JaxNative
from ksched_tpu_torch.drivers.synthetic import random_flow_problem
from ksched_tpu_torch.graph.device_export import FlowProblem
from ksched_tpu_torch.solver.cpu_ref import ReferenceSolver
from ksched_tpu_torch.solver.native import NativeSolver

from test_solver_oracle import make_problem


def _as(cls, problem):
    """The same problem as a FlowProblem of the other package."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(problem).items() if k in names})


def _same(a, b):
    assert a.objective == b.objective
    assert a.iterations == b.iterations
    np.testing.assert_array_equal(a.flow, b.flow)
    assert a.flow.dtype == b.flow.dtype


@pytest.mark.parametrize("algorithm", ["ssp", "cost_scaling"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flows_and_objective_match(algorithm, seed):
    rng = np.random.default_rng(seed)
    p = random_flow_problem(rng, 60, 8, 4, arc_slots=512 if seed % 2 else None)
    got = NativeSolver(algorithm=algorithm).solve(p)
    want = JaxNative(algorithm=algorithm).solve(_as(JaxProblem, p))
    _same(got, want)
    assert got.objective == ReferenceSolver().solve(p).objective


def test_lower_bound_fold_and_negative_costs():
    for problem in (
        make_problem(4, {1: 1, 3: -1}, [(1, 2, 1, 1, 7), (2, 3, 0, 1, 0), (1, 3, 0, 1, 1)]),
        make_problem(4, {1: 1, 3: -1}, [(1, 2, 0, 1, -2), (2, 3, 0, 1, 3), (1, 3, 0, 1, 5)]),
    ):
        got = NativeSolver().solve(_as(FlowProblem, problem))
        _same(got, JaxNative().solve(problem))


def test_warm_start_across_rounds_matches():
    """Warm contexts carry the same prices: a perturbed second round
    takes the same iterations and flows in both packages, and reset()
    goes cold in both."""
    rng = np.random.default_rng(7)
    p1 = random_flow_problem(rng, 80, 10, 3)
    cost = p1.cost.copy()
    cost[::7] += 2
    p2 = dataclasses.replace(p1, cost=cost)
    t, j = NativeSolver(), JaxNative()
    for p in (p1, p2, p2):
        _same(t.solve(p), j.solve(_as(JaxProblem, p)))
    t.reset()
    j.reset()
    _same(t.solve(p1), j.solve(_as(JaxProblem, p1)))


@pytest.mark.parametrize("excess,arcs,match", [
    ({1: 2, 2: -1}, [(1, 2, 0, 2, 1)], "unbalanced"),
    ({1: 1, 3: -1}, [(1, 2, 0, 1, 1)], "infeasible"),
])
def test_errors_match(excess, arcs, match):
    problem = make_problem(4, excess, arcs)
    with pytest.raises(RuntimeError, match=match) as tj:
        JaxNative().solve(problem)
    with pytest.raises(RuntimeError, match=match) as tt:
        NativeSolver().solve(_as(FlowProblem, problem))
    assert str(tt.value) == str(tj.value)


def test_nan_cost_rejected():
    from ksched_tpu_torch.runtime.chaos import poison_costs

    p = random_flow_problem(np.random.default_rng(1), 20, 4, 2)
    with pytest.raises(ValueError, match="non-finite"):
        NativeSolver().solve(poison_costs(p))


def test_make_backend_native_and_failed_build(monkeypatch):
    """make_backend("native") is the C++ solver; a failed build raises,
    and no other backend takes its place."""
    import ksched_tpu_torch.native as native_pkg
    from ksched_tpu_torch.solver.select import make_backend

    b = make_backend("native", device="cpu")
    assert isinstance(b, NativeSolver)
    p = random_flow_problem(np.random.default_rng(4), 30, 6, 2)
    _same(b.solve(p), JaxNative().solve(_as(JaxProblem, p)))

    def broken(force_build=False):
        raise RuntimeError("native solver build failed: no g++")

    monkeypatch.setattr(native_pkg, "load_library", broken)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="build failed"):
            make_backend("native", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("nope", device="cpu")


def test_forced_build_reloads():
    from ksched_tpu_torch.native import library_path, load_library

    lib = load_library(force_build=True)
    assert lib.ksched_mcmf_ctx_new is not None
    assert library_path().endswith("libksched_mcmf.so")
