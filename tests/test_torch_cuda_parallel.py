"""The multi-device rung on the card: the mesh's collectives on CUDA
tensors over gloo (two ranks share the one card), the slot-stable
sharded solve on the card equal to the same ranks' solve on the CPU
(the device-resident sharded mirror too), and WhatIfSolver's scenarios
on the transport kernel equal to its plain version. Marked `cuda`; every
test skips where no CUDA device is present. Imports nothing of JAX, so
it runs on a machine without it:

    python -m pytest tests/test_torch_cuda_parallel.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parallel_cases import rank_values  # noqa: E402

pytestmark = pytest.mark.cuda

WORLD = 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.fixture(scope="module")
def ranks():
    _need_card()
    from ksched_tpu_torch.parallel.launch import run_ranks

    return run_ranks("torch_parallel_cases:cuda_cases", WORLD, deadline_s=600)


def test_collectives_on_cuda_tensors_over_gloo(ranks):
    xs = np.stack([rank_values(WORLD, r, (3, 5)) for r in range(WORLD)])
    cols = np.stack([rank_values(WORLD + 7, r, (2, 6)) for r in range(WORLD)])
    whole = np.concatenate(list(cols), axis=1)
    excl = np.cumsum(whole, axis=1, dtype=np.int32) - whole
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo"
        np.testing.assert_array_equal(out["psum"], xs.sum(0, dtype=np.int32))
        np.testing.assert_array_equal(out["pmax"], xs.max(0))
        np.testing.assert_array_equal(out["pmin"], xs.min(0))
        np.testing.assert_array_equal(out["gather"], xs)
        np.testing.assert_array_equal(out["prefix"], excl[:, 6 * r:6 * (r + 1)])


@pytest.mark.parametrize("kind", ["slot", "resident"])
def test_sharded_solve_on_the_card_equals_the_cpu(ranks, kind):
    for out in ranks:
        card, cpu = out[f"{kind}_card"], out[f"{kind}_cpu"]
        assert len(card) == len(cpu)
        for rnd, (a, b) in enumerate(zip(card, cpu)):
            np.testing.assert_array_equal(a[0], b[0], err_msg=f"round {rnd}")
            assert a[1:5] == b[1:5], rnd
            if a[5] is not None:
                np.testing.assert_array_equal(a[5], b[5])


@pytest.mark.parametrize("C", [1, 3])
def test_whatif_on_the_kernel_equals_plain(C):
    _need_card()
    from ksched_tpu_torch.ops.transport import transport_loop
    from ksched_tpu_torch.parallel.whatif import WhatIfSolver

    rng = np.random.default_rng(0)
    M, K = 200, 6
    cost = rng.integers(0, 15, (K, C, M)).astype(np.int64)
    supply = rng.integers(0, 300, (K, C)).astype(np.int64)
    col_cap = rng.integers(0, 4, (K, M)).astype(np.int64)
    transport_loop.launches = 0
    card = WhatIfSolver(M, C, unsched_cost=25, ec_cost=2).solve_batch(cost, supply, col_cap)
    launches = transport_loop.launches
    cpu = WhatIfSolver(M, C, unsched_cost=25, ec_cost=2, device="cpu").solve_batch(
        cost, supply, col_cap)
    for a, b in ((card.y, cpu.y), (card.objective, cpu.objective),
                 (card.num_unsched, cpu.num_unsched), (card.converged, cpu.converged)):
        np.testing.assert_array_equal(a, b)
    if C == 1:
        assert launches == 0  # the closed form launches nothing
    else:
        assert launches >= K  # one a scenario, two where the short start retries
