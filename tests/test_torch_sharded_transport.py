"""The port's sharded layered transport (ksched_tpu_torch/parallel/
sharded_transport.py) on gloo ranks on the CPU against the JAX
package's: at D = 2 against `ksched_tpu.parallel.sharded_transport` on
the conftest's virtual 2-device mesh, at D = 4 against the JAX
package's single-device solves (`_solve_transport`, its tiered twin
and LayeredTransportSolver), which its own tests hold equal to the
sharded ones at any D; and against the port's own single-device solves.
y, superstep counts and converged flags, tolerance 0, plain and tiered
(refine_waves 0 and 8); ShardedLayeredSolver's results on a contended
instance and on the closed forms; the collectives a superstep issues.
One spawn of 4 ranks runs every case (ksched_tpu_torch/parallel/launch.py)."""

import numpy as np
import pytest
import torch

from ksched_tpu_torch.parallel.launch import run_ranks
from torch_parallel_cases import (
    PLAIN,
    TIERED,
    layered_problems,
    tiered_instance,
    transport_instance,
)

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("torch_parallel_cases:transport_cases", WORLD)


@pytest.fixture(scope="module")
def mesh2():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), ("x",))


def _same_on_members(ranks, key, D):
    first = ranks[0][key]
    for r in range(1, D):
        other = ranks[r][key]
        np.testing.assert_array_equal(other[0], first[0], err_msg=f"rank {r} {key}")
        assert other[1:] == first[1:], (r, key)
    return first


def _jax_plain(inst, mesh=None):
    import jax.numpy as jnp

    from ksched_tpu.solver.layered import _solve_transport

    wS, sup, cap, eps0 = inst
    if mesh is not None:
        from ksched_tpu.parallel.sharded_transport import sharded_transport_solve

        y, steps, conv = sharded_transport_solve(mesh, jnp.asarray(wS), jnp.asarray(sup),
                                                 jnp.asarray(cap), jnp.int32(eps0))
        return np.asarray(y), int(steps), bool(conv)
    y, _pm, steps, conv = _solve_transport(jnp.asarray(wS), jnp.asarray(sup),
                                           jnp.asarray(cap), jnp.int32(eps0),
                                           max_supersteps=1 << 17)
    return np.asarray(y), int(steps), bool(conv)


def _jax_tiered(inst, waves, mesh=None):
    import jax.numpy as jnp

    wLo, wHi, R, sup, cap, eps0 = inst
    args = tuple(jnp.asarray(x) for x in (wLo, wHi, R, sup, cap))
    if mesh is not None:
        from ksched_tpu.parallel.sharded_transport import sharded_transport_solve_tiered

        y, steps, conv = sharded_transport_solve_tiered(mesh, *args, jnp.int32(eps0),
                                                        refine_waves=waves)
        return np.asarray(y), int(steps), bool(conv)
    from ksched_tpu.solver.layered import _solve_transport_tiered

    y, _pm, steps, conv = _solve_transport_tiered(*args, jnp.int32(eps0),
                                                  max_supersteps=1 << 17,
                                                  refine_waves=waves)
    return np.asarray(y), int(steps), bool(conv)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", PLAIN, ids=lambda c: "_".join(map(str, c)))
def test_plain_matches_the_jax_package_exactly(ranks, mesh2, D, case):
    from ksched_tpu_torch.solver.layered import _solve_transport

    inst = transport_instance(*case)
    y, steps, conv = _same_on_members(ranks, f"plain{D}_" + "_".join(map(str, case)), D)
    jy, jsteps, jconv = _jax_plain(inst, mesh2 if D == 2 else None)
    np.testing.assert_array_equal(y, jy)
    assert (steps, conv) == (jsteps, jconv) and conv
    # the port's single-device plain solve (kernel B1's plain version)
    t = torch.tensor
    ty, _pm, tsteps, tconv = _solve_transport(t(inst[0]), t(inst[1]), t(inst[2]), inst[3],
                                              max_supersteps=1 << 17)
    np.testing.assert_array_equal(y, ty.numpy())
    assert (steps, conv) == (int(tsteps), bool(tconv))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", TIERED, ids=lambda c: "_".join(map(str, c)))
def test_tiered_matches_the_jax_package_exactly(ranks, mesh2, D, case):
    from ksched_tpu_torch.solver.layered import _solve_transport_tiered

    *shape, waves = case
    inst = tiered_instance(*shape)
    y, steps, conv = _same_on_members(ranks, f"tiered{D}_" + "_".join(map(str, case)), D)
    jy, jsteps, jconv = _jax_tiered(inst, waves, mesh2 if D == 2 else None)
    np.testing.assert_array_equal(y, jy)
    assert (steps, conv) == (jsteps, jconv) and conv
    t = torch.tensor
    ty, _pm, tsteps, tconv = _solve_transport_tiered(
        *(t(x) for x in inst[:5]), inst[5], max_supersteps=1 << 17, refine_waves=waves)
    np.testing.assert_array_equal(y, ty.numpy())
    assert (steps, conv) == (int(tsteps), bool(tconv))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", ["multi", "single", "degenerate"])
def test_sharded_layered_solver_matches_the_jax_package(ranks, mesh2, D, name):
    from ksched_tpu.parallel.sharded_transport import ShardedLayeredSolver as JSharded
    from ksched_tpu.solver.layered import LayeredProblem as JLP
    from ksched_tpu.solver.layered import LayeredTransportSolver as JLayered

    from ksched_tpu_torch.solver.layered import LayeredProblem, LayeredTransportSolver

    lp = layered_problems()[name]
    y, obj, unsched, steps, last = ranks[0][f"layered{D}_{name}"]
    for r in range(1, D):
        ry, *rest = ranks[r][f"layered{D}_{name}"]
        np.testing.assert_array_equal(ry, y)
        assert tuple(rest) == (obj, unsched, steps, last)
    jsolver = JSharded(mesh2) if D == 2 else JLayered()
    jr = jsolver.solve_layered(JLP(**lp))
    np.testing.assert_array_equal(y, jr.y)
    assert (obj, unsched, steps) == (jr.objective, jr.num_unsched, jr.supersteps)
    assert last == jsolver.last_supersteps
    tr = LayeredTransportSolver(device="cpu").solve_layered(LayeredProblem(**lp))
    np.testing.assert_array_equal(y, tr.y)
    assert (obj, steps) == (tr.objective, tr.supersteps)
    if name != "multi":
        assert steps == 0  # the closed forms, on every rank


@pytest.mark.parametrize("D", [2, 4])
def test_collectives_per_superstep(ranks, D):
    """Each plain superstep issues two excess psums, the active-column
    psum, two all_gathers for the row and sink prefixes, the pushed-row
    and pushed-sink psums and the best-row and sink-candidate pmaxes;
    the rest is per phase and per solve."""
    sites, steps = ranks[0][f"per_superstep{D}"]
    assert steps > 0
    assert sites["superstep"] == {"all_gather": 2 * steps, "pmax": 2 * steps,
                                  "psum": 2 * steps}
    assert sites["active"]["psum"] >= steps
    assert sites["excess"]["psum"] == 2 * (sites["active"]["psum"] + len(PLAIN))


@pytest.mark.parametrize("D", [2, 4])
def test_columns_must_divide_over_the_mesh(ranks, D):
    assert "not divisible by the mesh size" in ranks[0][f"indivisible{D}"]
