"""The general-graph event path, port against the JAX package, round by
round and bit for bit: Scenario W(20, 200) through make_backend("mega")
(every round on the mcmf kernel's plain version; from round 1 on the
warm attempt spends its 4,096 supersteps and the cold one converges)
and Scenario P(20, 200) through make_backend("auto") (round 0 dense,
later rounds on the mega rung). Equal per round: tasks placed,
the path, supersteps, objective and the sorted bindings. The JAX side
runs its MegaSolver on the stand-in for the Pallas kernel
(tests/torch_event_mega_reference.py), patched in for the test only."""

import pytest

import ksched_tpu.ops.mcmf_pallas as mcmf_pallas
from ksched_tpu_torch.drivers import trivial_preempt_rounds, whare_mixed_rounds
from ksched_tpu_torch.solver.select import make_backend

from torch_event_mega_reference import bindings_sha256, mega_standin, reference


@pytest.mark.parametrize("name,backend", [("W", "mega"), ("P", "auto")])
def test_scenario_matches_jax(name, backend, monkeypatch):
    monkeypatch.setattr(mcmf_pallas, "mcmf_loop_pallas", mega_standin)
    want = reference(name, 20, 200, rounds=4)
    assert "stall" not in want and len(want["placed"]) == 4

    solver = make_backend(backend, device="cpu")
    rounds = whare_mixed_rounds if name == "W" else trivial_preempt_rounds
    got = {k: [] for k in want}
    for _r, sched, placed in rounds(20, 200, solver):
        got["placed"].append(placed)
        got["path"].append(getattr(solver, "last_path", "mega"))
        got["supersteps"].append(solver.last_supersteps)
        got["objective"].append(sched.solver.last_result.objective)
        got["bindings_sha256"].append(bindings_sha256(sched))
    assert got == want
    mega = solver if name == "W" else solver.mega
    assert mega.fallback is None or mega.fallback.last_supersteps == 0
    if name == "P":
        assert want["path"][0] == "dense" and set(want["path"][1:]) == {"mega"}
