"""utils/threefry.py against jax.random, bit for bit: every call the JAX
package's steady round makes (ksched_tpu/scheduler/device_bulk.py
steady_round and steady_scan) — PRNGKey(seed), split(key, n) and
split(key, 4), uniform(k, (Tcap,)) as float32, randint(k, (Tcap,), 0,
n) as int32 and randint(k, (), 0, 1 << 30) — on numpy words (the
host's keys) and on torch tensors (the rounds' bits), at small shapes
and at Tcap = 65,536, and the whole steady draw of several rounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksched_tpu_torch.utils import threefry

SEEDS = [0, 3, 7, 11, 2**31 - 1, 2**32 + 5, -1, -(2**31)]


def _key(key, backend):
    """A JAX key's words as the module takes them: int64 numpy or torch."""
    k = np.asarray(key).astype(np.int64)
    return torch.as_tensor(k) if backend == "torch" else k


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    key = jax.random.PRNGKey(seed)
    k = threefry.prng_key(seed)
    np.testing.assert_array_equal(k, np.asarray(key))
    for n in (1, 2, 4, 5, 160):
        got = threefry.split(k, n)
        assert got.dtype == np.int64 and got.shape == (n, 2)
        np.testing.assert_array_equal(got, np.asarray(jax.random.split(key, n)))
    # split of a batch of keys, as the steady draw splits every round's key
    keys = jax.random.split(key, 3)
    np.testing.assert_array_equal(
        threefry.split(np.asarray(keys).astype(np.int64), 4),
        np.stack([np.asarray(jax.random.split(x, 4)) for x in keys]))
    # the same on a tensor
    got = threefry.split(_key(keys, "torch"), 4)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.stack([np.asarray(jax.random.split(x, 4)) for x in keys]))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("n", [1, 2, 7, 1024, 65_536])
def test_uniform_bits(n, backend):
    for seed in (0, 5):
        key = jax.random.split(jax.random.PRNGKey(seed), 2)[1]
        want = np.asarray(jax.random.uniform(key, (n,)))
        got = _np(threefry.uniform(_key(key, backend), n))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("maxval", [1, 2, 3, 4, 20, 512, 65_537, 1 << 30, 2**31 - 1])
def test_randint(maxval, backend):
    key = jax.random.split(jax.random.PRNGKey(3), 4)[2]
    for n in (1, 5, 65_536):
        want = np.asarray(jax.random.randint(key, (n,), 0, maxval))
        got = _np(threefry.randint(_key(key, backend), n, 0, maxval))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # a traced int32 bound, as the group-mode arrival draw's arrival_n
    want = np.asarray(jax.jit(lambda k, m: jax.random.randint(k, (9,), 0, m))(
        key, jnp.int32(maxval)))
    np.testing.assert_array_equal(_np(threefry.randint(_key(key, backend), 9, 0, maxval)),
                                  want)


def test_scalar_randint():
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, (), 0, 1 << 30))
        got = threefry.randint(threefry.prng_key(seed), 0, 0, 1 << 30)
        assert got.shape == () and got.dtype == np.int32 and got == want


@pytest.mark.parametrize("grouped", [False, True])
def test_steady_draws_match_the_steady_scan(grouped):
    """steady_keys on the host and steady_draws on tensors — one round's
    keys, and a chunk of rounds in one pass — against the draws of the
    JAX steady scan (device_bulk.py:1453-1476, :1628-1636) at Tcap =
    65,536: per round split(key, 4), uniform(k1), randint(k2),
    randint(k3) (not drawn in group mode) and randint(k4, (), 0,
    1 << 30)."""
    R, Tcap, C, J, arrival_n = 3, 65_536, 4, 20, 480
    keys, offsets = threefry.steady_keys(6, R, grouped)
    assert keys.shape == (R, 3 if grouped else 5, 2) and offsets.dtype == np.int32
    keys = torch.as_tensor(keys)
    chunk = threefry.steady_draws(keys, Tcap, arrival_n if grouped else C, J)
    for r, key in enumerate(jax.random.split(jax.random.PRNGKey(6), R)):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        got = threefry.steady_draws(keys[r], Tcap, arrival_n if grouped else C, J)
        want = [jax.random.uniform(k1, (Tcap,)),
                jax.random.randint(k2, (Tcap,), 0, arrival_n if grouped else C),
                (jnp.zeros(Tcap, jnp.int32) if grouped
                 else jax.random.randint(k3, (Tcap,), 0, J))]
        for g, c, w in zip(got, chunk, want):
            g, c, w = g.numpy(), c[r].numpy(), np.asarray(w)
            assert g.dtype == c.dtype == w.dtype
            if w.dtype == np.float32:
                g, c, w = g.view(np.uint32), c.view(np.uint32), w.view(np.uint32)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(c, w)
        assert offsets[r] == np.asarray(jax.random.randint(k4, (), 0, 1 << 30))
