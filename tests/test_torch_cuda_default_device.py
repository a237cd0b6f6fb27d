"""The sharded rung on the card with every entry point on its default
device: `make_backend("sharded")`, `make_backend("auto")` whose fitting
gate escalates, and `build_degradation_ladder` over the sharded rung, on
2 gloo ranks sharing the card, each bit-identical to the single-card
CsrSolver (flows, objective, supersteps, potentials) and the ladder on
its sharded rung with no degradation; a tenancy lane on "cuda:0" under a
batcher on "cuda", and a mirror made on "cuda" taking a mesh made on
"cuda:0". An index-less "cuda" resolves to the card's index
(utils/device.py), so every device the port stores equals the device
its tensors report. Marked `cuda`; every test skips where no CUDA device
is present. Imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda_default_device.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda

WORLD = 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.fixture(scope="module")
def ranks():
    _need_card()
    from ksched_tpu_torch.parallel.launch import run_ranks

    return run_ranks("torch_parallel_cases:default_device_cases", WORLD, deadline_s=600)


def _card():
    return str(torch.empty(1, device="cuda").device)


def _assert_solved_equal(got, want):
    """(flow, objective, supersteps, potentials), bit for bit."""
    np.testing.assert_array_equal(got[0], want[0], err_msg="flow")
    assert got[1:3] == want[1:3], ("objective, supersteps", got[1:3], want[1:3])
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert got[3].dtype == want[3].dtype
        np.testing.assert_array_equal(got[3], want[3], err_msg="potentials")


def _assert_rows_equal(got, want, fields=(1, 2, 3)):
    """Churn-drive rows (flow, supersteps, objective, warm scope, plan
    kind, potentials): the flow, the potentials and `fields`."""
    assert len(got) == len(want)
    for rnd, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"round {rnd} flow")
        assert [g[i] for i in fields] == [w[i] for i in fields], rnd
        assert (g[5] is None) == (w[5] is None), rnd
        if w[5] is not None:
            np.testing.assert_array_equal(g[5], w[5], err_msg=f"round {rnd} potentials")


def test_resolve_device_names_the_card_as_its_tensors_do():
    _need_card()
    from ksched_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    assert dev.index is not None
    assert dev == torch.empty(1, device="cuda").device == resolve_device(dev)


def _case(out, name, rank):
    assert name not in out["errors"], f"rank {rank}: {out['errors'][name]}"
    return out[name]


def test_make_backend_sharded_on_its_default(ranks):
    for r, out in enumerate(ranks):
        devices, rows = _case(out, "sharded", r)
        assert devices == (_card(), _card()), r
        _assert_rows_equal(rows, out["csr"])
        assert len(rows) == 7


def test_make_backend_auto_escalates_on_its_default(ranks):
    for r, out in enumerate(ranks):
        path, lazy, budget_set, mega_refusal, mesh_device, solved = _case(out, "auto", r)
        assert (path, lazy, budget_set, mesh_device) == ("sharded", True, True, _card()), r
        assert "budget" in mega_refusal, mega_refusal
        _assert_solved_equal(solved, out["auto_csr"])


def test_ladder_over_sharded_stays_on_sharded(ranks):
    for r, out in enumerate(ranks):
        names, rung, degradations, solved = _case(out, "ladder", r)
        assert names == ["sharded", "jax", "cpu_ref"]
        assert (rung, degradations) == ("sharded", 0), r
        _assert_solved_equal(solved, out["auto_csr"])


def test_mirror_on_cuda_takes_a_mesh_on_cuda0(ranks):
    for r, out in enumerate(ranks):
        mirror_device, mesh_device, taken, rows = _case(out, "mirror", r)
        assert (mirror_device, mesh_device, taken) == (_card(), "cuda:0", True), r
        _assert_rows_equal(rows, out["csr"], fields=(1, 2))


def test_lane_on_cuda0_is_taken_by_a_batcher_on_cuda():
    """The lane solves on the card as the same lane does on the CPU."""
    _need_card()
    from ksched_tpu_torch.drivers.synthetic import random_flow_problem
    from ksched_tpu_torch.tenancy.batch import LaneSolver, StackedBatcher

    batcher = StackedBatcher(device="cuda")
    lane = LaneSolver(batcher, device="cuda:0")
    assert lane.device == batcher.device
    problem = random_flow_problem(np.random.default_rng(11), 9, 3, 2)
    got = lane.solve(problem)
    on_cpu = LaneSolver(StackedBatcher(device="cpu"), device="cpu")
    want = on_cpu.solve(problem)
    np.testing.assert_array_equal(got.flow, want.flow)
    assert (got.objective, lane.last_supersteps) == (want.objective, on_cpu.last_supersteps)
