"""The port's mesh (ksched_tpu_torch/parallel/mesh.py) on gloo ranks on
the CPU: psum, pmax, pmin, the owner-masked all_gather and the
two-level exclusive prefix against plain numpy reductions of what every
rank contributed (tolerance 0: int32, wrapping as `lax.psum` does), at
D = 2 (a subgroup: ShardMesh takes whatever group it is given) and
D = 4; collective counts by kind and call site; a collective that
waits for a rank that never comes fails within its group's timeout as
CollectiveError, which the degradation ladder does not absorb. One
spawn of 4 ranks runs every case (ksched_tpu_torch/parallel/launch.py)."""

import numpy as np
import pytest

from ksched_tpu_torch.parallel.launch import run_ranks
from torch_parallel_cases import rank_values

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("torch_parallel_cases:mesh_cases", WORLD)


def _members(D):
    return list(range(D))


def _contributions(seed, D, shape):
    return np.stack([rank_values(seed, r, shape) for r in range(D)])


@pytest.mark.parametrize("D", [2, 4])
def test_reductions_match_plain(ranks, D):
    xs = _contributions(D, D, (3, 5))
    for r in _members(D):
        out = ranks[r]
        np.testing.assert_array_equal(out[f"psum{D}"], xs.sum(0, dtype=np.int32))
        np.testing.assert_array_equal(out[f"pmax{D}"], xs.max(0))
        np.testing.assert_array_equal(out[f"pmin{D}"], xs.min(0))
        assert out[f"psum{D}"].dtype == np.int32
        assert out[f"scalar{D}"].shape == ()
        assert int(out[f"scalar{D}"]) == int(xs[:, 0, 0].sum())
        assert out[f"any{D}"] == (bool((xs > 990).any()), False)
        assert out[f"rank{D}"] == (r, D, "gloo")


@pytest.mark.parametrize("D", [2, 4])
def test_all_gather_is_owner_masked(ranks, D):
    xs = _contributions(D, D, (3, 5))
    for r in _members(D):
        np.testing.assert_array_equal(ranks[r][f"gather{D}"], xs)


@pytest.mark.parametrize("D", [2, 4])
def test_two_level_prefix_is_the_global_exclusive_cumsum(ranks, D):
    cols = _contributions(D + 7, D, (2, 6))  # [D, C, Mloc]
    whole = np.concatenate(list(cols), axis=1)  # the global column order
    excl = np.cumsum(whole, axis=1, dtype=np.int32) - whole
    for r in _members(D):
        np.testing.assert_array_equal(ranks[r][f"prefix{D}"], excl[:, 6 * r:6 * (r + 1)])


@pytest.mark.parametrize("D", [2, 4])
def test_int32_psum_wraps(ranks, D):
    big = np.array([(1 << 31) - 1 - r for r in range(D)], np.int64).sum()
    want = np.int64(big).astype(np.int32)  # the low 32 bits, as lax.psum
    for r in _members(D):
        assert (ranks[r][f"wrap{D}"] == want).all()


@pytest.mark.parametrize("D", [2, 4])
def test_collectives_are_counted_by_kind_and_site(ranks, D):
    totals, sites = ranks[0][f"counts{D}"]
    assert totals == {"psum": 4, "pmax": 1, "pmin": 1, "all_gather": 1}
    assert sites == {"a": {"pmax": 1, "psum": 1}, "b": {"all_gather": 1, "pmin": 1,
                                                        "psum": 1},
                     "c": {"psum": 2}}


def test_a_lone_collective_times_out_as_collective_error(ranks):
    assert ranks[0]["timeout"].startswith("CollectiveError: psum at 'lone' failed")


def test_a_rank_outside_the_group_is_refused(ranks):
    assert ranks[0]["outsider"].startswith("ValueError")


def test_mesh_needs_an_initialised_group():
    import torch.distributed as dist

    from ksched_tpu_torch.parallel.mesh import ShardMesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        ShardMesh(device="cpu")


def test_collective_errors_are_not_degradable():
    """A failed collective re-raises through the ladder (the ranks step
    down together or not at all); an ordinary solve failure steps down."""
    from ksched_tpu_torch.parallel.mesh import CollectiveError
    from ksched_tpu_torch.runtime.degrade import DegradingSolver, is_kernel_failure
    from ksched_tpu_torch.solver.base import FlowSolver

    assert is_kernel_failure(CollectiveError("psum at 'x' failed"))
    assert not is_kernel_failure(RuntimeError("did not converge"))

    class Broken(FlowSolver):
        def solve(self, problem):
            raise CollectiveError("psum at 'superstep' failed on rank 0 of 2")

    class Never(FlowSolver):
        def solve(self, problem):  # pragma: no cover - must not be reached
            raise AssertionError("the ladder stepped down")

    ladder = DegradingSolver([("sharded", Broken()), ("jax", Never())], device="cpu")
    from torch_parallel_cases import legacy_problems

    with pytest.raises(CollectiveError):
        ladder.solve(legacy_problems()[0])
