"""MegaSolver on the device-resident export, in both packages, on the
CPU: Scenario W(20, 200) through make_backend("mega"), rounds 0-2
(resident: the pow2 extents meet the kernel's 256 floor). The JAX
package's MegaSolver gives the same values on the resident handle as on
the host arrays (its kernel through the CPU stand-in of
tests/torch_event_mega_reference.py); the port's resident rounds give
them too (kernel B3 through its plain version), each solve handed the
mirror's own cap, scaled-cost and supply tensors. Equal per round:
tasks placed, supersteps, objective, the bindings' sha256."""

import pytest

import ksched_tpu.ops.mcmf_pallas as mcmf_pallas
import ksched_tpu.solver.placement as jplacement
import ksched_tpu_torch.ops as ops
from ksched_tpu_torch.drivers import whare_mixed_rounds
from ksched_tpu_torch.solver.mega_solver import MegaSolver
from ksched_tpu_torch.solver.select import make_backend

from torch_event_mega_reference import (
    bindings_sha256,
    make_solver,
    mega_standin,
    scenario_rounds,
)

ROUNDS = 3


def _jax_rounds(resident, monkeypatch):
    init = jplacement.PlacementSolver.__init__

    def resident_init(self, gm, backend, incremental=True, device_resident=False):
        init(self, gm, backend, incremental, device_resident=resident)

    monkeypatch.setattr(jplacement.PlacementSolver, "__init__", resident_init)
    backend = make_solver("W")
    out = []
    for r, sched, placed in scenario_rounds("W", 20, 200, backend):
        out.append((placed, backend.last_supersteps,
                    sched.solver.last_result.objective, bindings_sha256(sched)))
        assert (sched.solver.resident is not None) == resident
        if r == ROUNDS - 1:
            break
    assert backend.fallback.last_supersteps == 0
    monkeypatch.setattr(jplacement.PlacementSolver, "__init__", init)
    return out


def test_resident_mega_rounds_match_host_rounds(monkeypatch):
    monkeypatch.setattr(mcmf_pallas, "mcmf_loop_pallas", mega_standin)
    host = _jax_rounds(False, monkeypatch)
    assert _jax_rounds(True, monkeypatch) == host

    backend = make_backend("mega", device="cpu")
    assert isinstance(backend, MegaSolver)
    launched = []
    solve = ops.mcmf_solve

    def record(cap, cost, supply, *args, **kw):
        launched.append((cap, cost, supply))
        return solve(cap, cost, supply, *args, **kw)

    monkeypatch.setattr(ops, "mcmf_solve", record)
    got = []
    for r, sched, placed in whare_mixed_rounds(20, 200, backend, device_resident=True):
        res = sched.solver.resident
        cap, cost, supply = launched[-1]
        assert cap is res.d_cap and supply is res.d_excess, f"round {r}"
        assert cost is res._scaled[1], f"round {r}"
        got.append((placed, backend.last_supersteps,
                    sched.solver.last_result.objective, bindings_sha256(sched)))
        res.parity_check()
        if r == ROUNDS - 1:
            break
    assert got == host
    assert backend._prev_dev is not None and backend.fallback.last_supersteps == 0
