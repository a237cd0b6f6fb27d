"""The JAX package's steady-round random draws, reproduced without JAX.

`DeviceBulkCluster.run_steady_rounds(seed=...)` in the JAX package
draws its churn with jax.random under the default PRNG (threefry2x32,
partitionable key splits and bit generation):

    keys = split(PRNGKey(seed), num_rounds)
    per round: k1, k2, k3, k4 = split(key, 4)
        uniform(k1, (Tcap,))                 float32
        randint(k2, (Tcap,), 0, n2)          int32
        randint(k3, (Tcap,), 0, n3)          int32
        randint(k4, (), 0, 1 << 30)          int32

This module computes the same values bit for bit. Words are uint32
values held in int64 numpy arrays or torch tensors and masked to 32
bits after every addition and shift, so one code path serves both: the
host makes a run's keys (`steady_keys`, a few words a round), and the
Tcap-long bits of a chunk of rounds are drawn where the cluster lives
(`steady_draws`, one threefry over all of the chunk's counters).
A key is an array or tensor of shape [..., 2]; every function
broadcasts over the leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) & _M) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over the
    broadcast of key words k1, k2 and counter words x1, x2 (uint32
    values in int64). Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _M
    x1 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def prng_key(seed: int):
    """PRNGKey(seed) with 64-bit types off (the JAX default), on the
    host: the seed as an int32 word, its bits the key's low word, the
    high word 0."""
    return np.array([0, int(seed) & _M], np.int64)  # kschedlint: host-only (the key words on the host)


def _hash_iota(key, n: int):
    """threefry over the counters 0..n-1 (high word 0, low word i) under
    key [..., 2]: two words of shape [..., n]."""
    lo = (torch.arange(n, dtype=torch.int64, device=key.device) if _is_torch(key)  # kschedlint: disable=dtype64 -- threefry's 64-bit counter words, masked to 32 bits
          else np.arange(n, dtype=np.int64))  # kschedlint: host-only (the host twin of the counters)
    return threefry2x32(key[..., 0:1], key[..., 1:2], 0, lo)


def split(key, num: int):
    """split(key, num): keys of shape [..., num, 2]."""
    b1, b2 = _hash_iota(key, num)
    return torch.stack([b1, b2], -1) if _is_torch(key) else np.stack([b1, b2], -1)


def random_bits(key, n: int):
    """32 random bits per element: [..., n]."""
    b1, b2 = _hash_iota(key, n)
    return b1 ^ b2


def _uniform_from_bits(bits):
    """float32 in [1, 2) from the top 23 bits, minus 1: jax.random's
    uniform for float32 in [0, 1)."""
    f = (bits >> 9) | 0x3F800000
    if _is_torch(f):
        return f.to(torch.int32).view(torch.float32) - 1.0
    return f.astype(np.int32).view(np.float32) - np.float32(1.0)


def _randint_from_bits(hi, lo, minval: int, maxval: int):
    """jax.random.randint's int32 draw from two words of bits: the
    higher word times (2^16)^2 mod span plus the lower word, mod span,
    in wrapping uint32 arithmetic (span < 2^31, so every product fits
    int64 before the mask)."""
    span = maxval - minval if maxval > minval else 1
    mult = (((1 << 16) % span) ** 2 & _M) % span
    off = (((((hi % span) * mult) & _M) + lo % span) & _M) % span
    out = off + minval
    return out.to(torch.int32) if _is_torch(out) else out.astype(np.int32)


def uniform(key, n: int):
    """uniform(key, (n,)) in [0, 1): float32 [..., n]."""
    return _uniform_from_bits(random_bits(key, n))


def randint(key, n: int, minval: int, maxval: int):
    """randint(key, (n,), minval, maxval) as int32 [..., n]; n = 0 draws
    the scalar shape (): [...]."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], max(n, 1))
    lo = random_bits(keys[..., 1, :], max(n, 1))
    out = _randint_from_bits(hi, lo, minval, maxval)
    return out[..., 0] if n == 0 else out


def steady_keys(seed: int, num_rounds: int, grouped: bool):
    """The keys of `num_rounds` steady rounds of the JAX package's
    `run_steady_rounds(seed=seed)`, on the host: (keys int64[R, K, 2] —
    per round uniform's key, then randint's two keys for the class (or,
    grouped, the arrival-map index), then for the job unless grouped: K
    is 3 grouped, else 5 —, window_offset int32[R])."""
    keys = split(prng_key(seed), int(num_rounds))
    k = split(keys, 4)  # [R, 4, 2]
    parts = [k[:, 0:1], split(k[:, 1], 2)]
    if not grouped:
        parts.append(split(k[:, 2], 2))
    return np.concatenate(parts, axis=1), randint(k[:, 3], 0, 0, 1 << 30)


def steady_draws(keys, task_capacity: int, range_a: int, range_b: int):
    """Steady rounds' draws from their keys (int64[..., K, 2], rows of
    steady_keys, on the device that draws), in one pass: (done_u
    float32[..., Tcap], draw_a int32[..., Tcap] in [0, range_a), draw_b
    int32[..., Tcap] in [0, range_b) — zeros when K is 3, the group
    mode that draws no job)."""
    bits = random_bits(keys, task_capacity)  # [..., K, Tcap]
    done_u = _uniform_from_bits(bits[..., 0, :])
    draw_a = _randint_from_bits(bits[..., 1, :], bits[..., 2, :], 0, range_a)
    if keys.shape[-2] == 3:
        return done_u, draw_a, torch.zeros_like(draw_a)
    return done_u, draw_a, _randint_from_bits(bits[..., 3, :], bits[..., 4, :], 0, range_b)
