"""The port's tiered transport solve and the device round's bounded
solves against the JAX package, bit for bit (tolerance 0: integer
arithmetic), dtypes included:

- the plain tiered solve (ksched_tpu_torch solver/layered.py
  `_solve_transport_tiered`, the CPU twin of the CUDA kernel in
  ksched_tpu_torch/ops/csrc/transport_tiered.cu) against JAX's XLA
  tiered loop and its Pallas tiered kernel (interpreted);
- `transport_fori` and `transport_fori_tiered`: the single-row closed
  forms, the class-degenerate split, and a short-eps start that stalls
  and takes the full-range retry;
- the tensor closed forms `solve_row_constant`, `solve_single_class`
  and `split_grants_by_class`.

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ksched_tpu.ops import transport_loop_pallas_tiered
from ksched_tpu.solver import layered as jl
from ksched_tpu_torch import ops as tops
from ksched_tpu_torch.ops.transport import transport_loop_tiered
from ksched_tpu_torch.solver import layered as tl


def _instance(seed, C, M):
    """tests/test_pallas_transport.py's tiered instance: scaled costs as
    the dear tier, a random discount off every real column for the cheap
    tier, scattered residents (none on the escape column)."""
    rng = np.random.default_rng(seed)
    Mp, n_scale = jl.pad_geometry(M, C)
    wS = np.zeros((C, Mp), np.int32)
    wS[:, :M] = rng.integers(-30, 30, (C, M)).astype(np.int64) * n_scale
    supply = rng.integers(0, 60, C).astype(np.int32)
    col_cap = np.zeros(Mp, np.int32)
    col_cap[:M] = rng.integers(0, 25, M).astype(np.int32)
    col_cap[-1] = supply.sum()
    rng = np.random.default_rng(seed + 77)
    wLo = wS.copy()
    wLo[:, :M] -= int(rng.integers(1, 12)) * n_scale
    R = rng.integers(0, 6, (C, Mp)).astype(np.int32)
    R[:, -1] = 0
    return wLo, wS, R, supply, col_cap, n_scale


#: JAX's XLA tiered loop, compiled once per shape
_xla_loop_tiered = jax.jit(
    jl._transport_loop_tiered,
    static_argnames=("alpha", "max_supersteps", "refine_waves"),
)


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_same(port, ref):
    """port: torch tuple; ref: jax tuple, element by element."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype, (p.dtype, r.dtype)
        np.testing.assert_array_equal(p.numpy(), r)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("C,M", [(2, 5), (4, 40), (6, 130)])
def test_plain_tiered_matches_xla_loop_and_pallas_kernel(seed, C, M):
    """The shapes of tests/test_pallas_transport.py:71, refine 0 and 8."""
    wLo, wHi, R, supply, col_cap, _n = _instance(seed, C, M)
    eps0 = np.int32(max(1, np.abs(wHi).max()))
    U = np.minimum(supply[:, None], col_cap[None, :])
    for refine in (0, 8):
        port = tl._solve_transport_tiered(
            *_t(wLo, wHi, R, supply, col_cap), int(eps0), alpha=8,
            max_supersteps=50_000, refine_waves=refine,
        )
        assert bool(port[3])
        y, _z, pm, steps, conv = _xla_loop_tiered(
            *_j(wLo, wHi, np.minimum(R, U), U, supply, col_cap, eps0), alpha=8,
            max_supersteps=50_000, refine_waves=refine,
        )
        _assert_same(port, (y, pm, steps, conv))
        pallas = transport_loop_pallas_tiered(
            *_j(wLo, wHi, R, supply, col_cap, eps0), alpha=8,
            max_supersteps=50_000, interpret=True, refine_waves=refine,
        )
        _assert_same(port, pallas)


def test_tiered_budget_exhaustion_reports_unconverged():
    wLo, wHi, R, supply, col_cap, _n = _instance(1, 6, 130)
    eps0 = np.int32(max(1, np.abs(wHi).max()))
    port = tl._solve_transport_tiered(*_t(wLo, wHi, R, supply, col_cap), int(eps0),
                                      max_supersteps=9)
    ref = jl._solve_transport_tiered(*_j(wLo, wHi, R, supply, col_cap, eps0),
                                     max_supersteps=9)
    assert not bool(port[3]) and int(port[2]) == 9
    _assert_same(port, ref)


def test_tiered_solve_on_cpu_runs_the_plain_version():
    """ops.transport_solve_tiered dispatches on the tensor's device: a
    CPU tensor takes the plain version and launches nothing; an eps
    given as an int32 scalar tensor is the same start."""
    wLo, wHi, R, supply, col_cap, n_scale = _instance(2, 4, 40)
    before = transport_loop_tiered.launches
    got = tops.transport_solve_tiered(*_t(wLo, wHi, R, supply, col_cap),
                                      torch.tensor(n_scale, dtype=torch.int32))
    want = tl._solve_transport_tiered(*_t(wLo, wHi, R, supply, col_cap), n_scale)
    assert transport_loop_tiered.launches == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        meta = torch.zeros((2, 128), dtype=torch.int32, device="meta")
        transport_loop_tiered(meta, meta, meta, meta[:, 0], meta[0], 1)


# ---------------------------------------------------------------------------
# transport_fori / transport_fori_tiered
# ---------------------------------------------------------------------------


def _fori_pair(port, ref):
    """Compare (y, pm, steps, converged) from transport_fori(_tiered);
    the port's fifth element, what the host knows of the flag, is None
    or the flag itself."""
    _assert_same(port[:4], tuple(np.asarray(a) for a in ref))
    assert port[4] is None or port[4] == bool(port[3])


@pytest.mark.parametrize("seed", range(3))
def test_fori_single_row_closed_forms(seed):
    wLo, wHi, R, supply, col_cap, n_scale = _instance(seed, 1, 130)
    col_cap = col_cap.copy()
    col_cap[-1] = supply.sum()
    port = tl.transport_fori(*_t(wHi, supply, col_cap), 100, eps0=n_scale)
    ref = jl.transport_fori(*_j(wHi, supply, col_cap), 100, eps0=n_scale)
    _fori_pair(port, ref)
    port = tl.transport_fori_tiered(*_t(wLo, wHi, R, supply, col_cap), 100,
                                    eps0=n_scale)
    ref = jl.transport_fori_tiered(*_j(wLo, wHi, R, supply, col_cap), 100,
                                   eps0=n_scale)
    _fori_pair(port, ref)


@pytest.mark.parametrize("seed", range(3))
def test_fori_class_degenerate_split(seed):
    """Every row the same costs: the closed form on the total supply,
    grants split by class."""
    _wLo, wHi, _R, supply, col_cap, n_scale = _instance(seed, 5, 130)
    wS = np.repeat(wHi[:1], 5, axis=0)
    port = tl.transport_fori(*_t(wS, supply, col_cap), 100, eps0=n_scale,
                             class_degenerate=True)
    ref = jl.transport_fori(*_j(wS, supply, col_cap), 100, eps0=n_scale,
                            class_degenerate=True)
    _fori_pair(port, ref)


@pytest.mark.parametrize("refine", [0, 8])
def test_fori_iterative_matches(refine):
    wLo, wHi, R, supply, col_cap, n_scale = _instance(3, 4, 40)
    port = tl.transport_fori(*_t(wHi, supply, col_cap), 50_000, eps0=n_scale // 4,
                             refine_waves=refine)
    ref = jl.transport_fori(*_j(wHi, supply, col_cap), 50_000, eps0=n_scale // 4,
                            refine_waves=refine)
    _fori_pair(port, ref)
    port = tl.transport_fori_tiered(*_t(wLo, wHi, R, supply, col_cap), 50_000,
                                    eps0=n_scale, refine_waves=refine)
    ref = jl.transport_fori_tiered(*_j(wLo, wHi, R, supply, col_cap), 50_000,
                                   eps0=n_scale, refine_waves=refine)
    _fori_pair(port, ref)


def test_fori_short_start_stall_takes_the_retry():
    """A short start (eps0 = 1) that needs more supersteps than the
    budget: the attempt stalls, the one host read sees it, and the
    full-range retry converges; steps add up across the attempts.
    Seed 0 needs 267 supersteps from eps0 = 1 and 264 from the full
    range; the tiered seed 5 (refine 8) 272 and 169."""
    _wLo, wHi, _R, supply, col_cap, _n = _instance(0, 4, 40)
    reads = tl.read_flag.count
    port = tl.transport_fori(*_t(wHi, supply, col_cap), 265, eps0=1)
    ref = jl.transport_fori(*_j(wHi, supply, col_cap), 265, eps0=1)
    _fori_pair(port, ref)
    assert bool(port[3]) and int(port[2]) == 265 + 264
    assert tl.read_flag.count == reads + 1
    # the retry's flag is not read until a round branches on it
    assert port[4] is None
    assert tl.converged_on_host(port[3], port[4]) and tl.read_flag.count == reads + 2

    wLo, wHi, R, supply, col_cap, _n = _instance(5, 4, 40)
    port = tl.transport_fori_tiered(*_t(wLo, wHi, R, supply, col_cap), 200, eps0=1,
                                    refine_waves=8)
    ref = jl.transport_fori_tiered(*_j(wLo, wHi, R, supply, col_cap), 200, eps0=1,
                                   refine_waves=8)
    _fori_pair(port, ref)
    assert bool(port[3]) and int(port[2]) == 200 + 169


# ---------------------------------------------------------------------------
# tensor closed forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_tensor_closed_forms(seed):
    rng = np.random.default_rng(seed)
    G, M = 7, 50
    v = rng.integers(-20, 20, G).astype(np.int32)
    v[rng.integers(0, G)] = v[0]  # a tie, so the stable order matters
    supply = rng.integers(0, 40, G).astype(np.int32)
    col_cap = np.zeros(M + 1, np.int32)
    col_cap[:M] = rng.integers(0, 9, M)
    col_cap[-1] = supply.sum()
    _assert_same(
        (tl.solve_row_constant(*_t(v, supply, col_cap)),),
        (jl.solve_row_constant(*_j(v, supply, col_cap)),),
    )
    w = rng.integers(-5, 5, M + 1).astype(np.int32)  # many ties
    total = np.int32(supply.sum())
    _assert_same(
        (tl.solve_single_class(*_t(w, total, col_cap)),),
        (jl.solve_single_class(*_j(w, total, col_cap)),),
    )
    w2 = w - rng.integers(0, 3, M + 1).astype(np.int32)
    Rr = rng.integers(0, 4, M + 1).astype(np.int32)
    _assert_same(
        (tl.solve_single_class_tiered(*_t(w2, w, Rr, total, col_cap)),),
        (jl.solve_single_class_tiered(*_j(w2, w, Rr, total, col_cap)),),
    )
    y_tot = np.asarray(jl.solve_single_class(*_j(w, total, col_cap)))
    _assert_same(
        (tl.split_grants_by_class(*_t(y_tot, supply)),),
        (jl.split_grants_by_class(*_j(y_tot, supply)),),
    )
    # the numpy form is unchanged
    np.testing.assert_array_equal(
        tl.split_grants_by_class(y_tot, supply),
        jl.split_grants_by_class(y_tot, supply),
    )


def test_choose_eps0_on_tensors():
    i32 = torch.int32
    for total, cap in ((10, 20), (30, 20)):
        for short in (None, 64):
            want = jl.choose_eps0(256, 999, total, cap, short=short)
            got = tl.choose_eps0(256, torch.tensor(999, dtype=i32),
                                 torch.tensor(total, dtype=i32),
                                 torch.tensor(cap, dtype=i32), short=short)
            assert got.dtype == i32 and int(got) == int(want)
            assert tl.choose_eps0(256, 999, total, cap, short=short) == int(want)
