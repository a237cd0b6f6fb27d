"""bench.py's `churn` config in the port (ksched_tpu_torch/drivers/
churn.py) at a small size on the CPU: its three export arms
(full_rebuild, delta_scatter, device_resident) held equal to each other
every round, and to the JAX package's device-resident arm
(tests/torch_churn_reference.py, a twin of bench.py's
`_churn_pipeline_bench`), tolerance 0: per round supersteps, warm scope,
the placements' sha256 and, on the resident arm, the plan sync kind and
the bytes shipped; the fill's supersteps and the plan's rebuild,
overflow and relocation counters."""

import pytest

from ksched_tpu_torch.drivers.churn import ARMS, ChurnArm, run_churn

from torch_churn_reference import JaxChurnArm

SIZE = dict(tasks=400, machines=40, churn=0.05)
ROUNDS = 8


def test_three_arms_match_each_other_and_jax():
    jarm = JaxChurnArm(**SIZE)
    want = [jarm.drive_round(r) for r in range(ROUNDS)]
    seen = []
    out = run_churn(rounds=ROUNDS, device="cpu",
                    on_round=lambda arm, rec: seen.append(arm.label), **SIZE)
    assert seen == list(ARMS) * ROUNDS
    for label in ARMS:
        arm = out["objects"][label]
        assert arm.fill_supersteps == jarm.fill_supersteps, label
        for r, (got, ref) in enumerate(zip(out[label], want)):
            for key in ("supersteps", "warm_scope", "sha256"):
                assert got[key] == ref[key], f"{label} round {r}: {key}"
            assert got["host_reads"] > got["supersteps"], (label, r)
            if label == "device_resident":
                assert (got["plan_kind"], got["upload_bytes"]) == (
                    ref["plan_kind"], ref["upload_bytes"]), f"round {r}"
            else:
                assert got["plan_kind"] is None
    plan = out["objects"]["device_resident"].sched.solver.state.plan
    jplan = jarm.sched.solver.state.plan
    assert (plan.layout_rebuilds, plan.region_overflows, plan.region_relocations) == (
        jplan.layout_rebuilds, jplan.region_overflows, jplan.region_relocations)
    assert plan.region_relocations > 0
    assert {r["plan_kind"] for r in out["device_resident"]} == {"rebuild", "delta"}


def test_solver_upload_bytes_count_what_crosses():
    """The host arms' CsrSolver copies cap, cost and the warm flow
    (int32 per arc slot) and the supply (int32 per node slot) every
    round, plus the plan's value tensors on a round that moved its
    (layout_gen, value_version) and its static tensors on one that moved
    (layout_gen, static_version); the resident arm's solver copies
    nothing (the mirror counts its records)."""
    arms = [ChurnArm(label, device="cpu", **SIZE)
            for label in ("delta_scatter", "device_resident")]
    host, resident = arms
    for r in range(ROUNDS):
        plan = host.sched.solver.state.plan
        before = (plan.layout_gen, plan.value_version, plan.static_version)
        got = host.drive_round(r)["solver_upload_bytes"]
        after = (plan.layout_gen, plan.value_version, plan.static_version)
        p = host.sched.solver.state.problem()
        want = 4 * (3 * len(p.src) + len(p.excess))
        if before[:2] != after[:2]:
            want += plan.values_nbytes()
        if before[::2] != after[::2]:
            want += plan.static_nbytes()
        assert got == want, r
        assert got > 4 * (3 * len(p.src) + len(p.excess))  # churn dirties the plan
        assert resident.drive_round(r)["solver_upload_bytes"] == 0, r


def test_unknown_arm_is_refused():
    with pytest.raises(ValueError, match="unknown churn arm"):
        ChurnArm("reference", device="cpu", **SIZE)
