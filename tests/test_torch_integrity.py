"""The port's state integrity (ksched_tpu_torch/runtime/integrity.py)
against the JAX package's, on the CPU with tolerance 0: the torch
fingerprints equal host_fingerprint and the JAX package's jnp checksum
on int32 values whose products and sums overflow; every single-bit flip
moves them; the same injected flips are detected in both packages'
mirrors and healed by the same repair rungs (re-scatter, re-upload, the
full_build escalation); the mirror and slot-plan checks raise the
structured IntegrityError; the WAL framing writes the JAX package's
bytes and classifies each corruption kind."""

import numpy as np
import pytest
import torch

from ksched_tpu.graph import device_export as jde
from ksched_tpu.graph.flowgraph import FlowGraph as JaxGraph
from ksched_tpu.runtime import integrity as jig
from ksched_tpu_torch.graph import device_export as tde
from ksched_tpu_torch.graph.flowgraph import FlowGraph, NodeType
from ksched_tpu_torch.runtime import integrity as ig

INT32_CASES = [
    np.random.default_rng(7).integers(-(2**31), 2**31 - 1, 1000).astype(np.int32),
    np.array([2**31 - 1, -(2**31), -1, 2**30, 123456789] * 40, np.int32),
    np.zeros(16, np.int32),
    np.random.default_rng(8).integers(0, 2, 64).astype(bool),
    np.arange(-50, 50, dtype=np.int32),
]


@pytest.mark.parametrize("i", range(len(INT32_CASES)))
def test_fingerprints_agree_bit_for_bit(i):
    arr = INT32_CASES[i]
    host = ig.host_fingerprint(arr)
    assert host == jig.host_fingerprint(arr)
    dev = int(ig._device_fp1(torch.as_tensor(arr)))
    jax_fp = int(np.asarray(jig._one_fp(np.asarray(arr).astype(np.int32)))
                 .astype(np.int32).view(np.uint32))
    assert dev == host == jax_fp
    bufs = [torch.as_tensor(a) for a in INT32_CASES[:3]] * 2
    assert ig.device_fingerprints(bufs[:5]).tolist() == [
        ig.host_fingerprint(b.numpy()) for b in bufs[:5]]


def test_weights_match_and_are_odd():
    np.testing.assert_array_equal(ig.host_weights(4096), jig.host_weights(4096))
    assert (ig.host_weights(4096) % 2 == 1).all()
    w = ig._device_weights(4096, torch.device("cpu"))
    np.testing.assert_array_equal(w.numpy(), ig.host_weights(4096).astype(np.int64))


def test_every_single_bit_flip_moves_the_fingerprint():
    rng = np.random.default_rng(3)
    arr = rng.integers(-(2**31), 2**31 - 1, 256).astype(np.int32)
    t = torch.as_tensor(arr)
    base = int(ig._device_fp1(t))
    for i in (0, 1, 15, 17, 128, 255):
        for b in range(31):
            flipped = ig.corrupt_flip(t, i, b)
            assert int(ig._device_fp1(flipped)) != base, (i, b)
            assert int(ig._device_fp1(flipped)) == ig.host_fingerprint(flipped.numpy())
    assert int(ig._device_fp1(t)) == base  # the flip made a new tensor


def _build(pkg_graph, pkg_de, seed=0, num_tasks=12, num_machines=4, **res_kw):
    """tests/test_integrity.py's graph, as one package's DeviceGraphState
    and its mirror with the slot-stable plan enabled."""
    g = pkg_graph()
    sink = g.add_node()
    sink.type = NodeType.SINK
    machines = [g.add_node() for _ in range(num_machines)]
    escape = g.add_node()
    tasks = [g.add_node() for _ in range(num_tasks)]
    rng = np.random.default_rng(seed)
    for m in machines:
        g.change_arc(g.add_arc(m, sink), 0, int(rng.integers(2, 6)), int(rng.integers(0, 4)))
    g.change_arc(g.add_arc(escape, sink), 0, num_tasks, 50)
    for t in tasks:
        t.excess = 1
        for m in rng.choice(num_machines, size=min(3, num_machines), replace=False):
            g.change_arc(g.add_arc(t, machines[int(m)]), 0, 1, int(rng.integers(0, 10)))
        g.change_arc(g.add_arc(t, escape), 0, 1, 40)
    sink.excess = -num_tasks
    st = pkg_de.DeviceGraphState()
    st.full_build(g)
    res = pkg_de.DeviceResidentState(st, **res_kw)
    st.plan.ensure_built()
    res.refresh()
    return st, res


def _twins(seed=0):
    _jst, jres = _build(JaxGraph, jde, seed)
    _tst, tres = _build(FlowGraph, tde, seed, device="cpu")
    return jres, tres


@pytest.mark.parametrize("array", ["excess", "src", "dst", "cap", "cost",
                                   "p_sign", "p_arc", "p_src", "p_dst"])
@pytest.mark.parametrize("bit", [0, 5, 30])
def test_flip_detected_and_repaired_like_the_jax_package(array, bit):
    jres, tres = _twins()
    ja, ta = jig.StateAuditor(jres), ig.StateAuditor(tres)
    assert ja.audit() == ta.audit() == []
    np.testing.assert_array_equal(tres.plan_fingerprints(), jres.plan_fingerprints())
    spec = {"array": array, "index": 3, "bit": bit}
    jig.apply_device_corruption(jres, spec)
    ig.apply_device_corruption(tres, spec)
    diverged = ta.audit()
    assert diverged and diverged == ja.audit()
    assert [e.to_dict() for e in ta.diffs(diverged)] == [
        e.to_dict() for e in ja.diffs(diverged)]
    rung = ta.repair(diverged)
    assert rung == ja.repair(diverged)
    assert rung == ("reupload" if array.startswith("p_") else "rescatter")
    tres.parity_check()
    tres.plan_parity_check()
    assert ta.audit() == ja.audit() == [] and ta.counts == ja.counts


def test_warm_flow_divergence_escalates_to_full_build():
    _jres, tres = _twins()
    auditor = ig.StateAuditor(tres)
    host_flow = np.arange(64, dtype=np.int32)
    clean = torch.as_tensor(host_flow)
    assert auditor.audit(clean, host_flow) == []
    diverged = auditor.audit(ig.corrupt_flip(clean, 7, 12), host_flow)
    assert diverged == ["warm_flow"]
    with pytest.raises(ig.IntegrityError, match="full_build"):
        auditor.repair(diverged)


def _gate_run(flips):
    """The port's resident service at 6 x 8 through "jax", audited every
    round; after the fill, one round per entry of `flips` (a target, or
    None for a clean round), each flip applied just after the mirror's
    refresh. Returns (service, the integrity counts after each round)."""
    from ksched_tpu_torch.cluster import PodEvent
    from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service

    cfg = ServiceConfig(machines=6, pus_per_core=2, slots=8, pods=40, rounds=0,
                        backend="jax", device_resident=True, audit_every=1)
    svc = run_service(package("cpu"), cfg)["service"]
    sol = svc.scheduler.solver
    csr = sol.backend.primary
    refresh = sol.resident.refresh
    counts = []
    for i, target in enumerate(flips):
        pending = [target]

        def refresh_then_flip():
            problem = refresh()
            target = pending.pop() if pending else None  # once a round
            if target == "warm_flow":
                csr._prev_dev = ig.corrupt_flip(csr._prev_dev, 1, 3)
            elif target is not None:
                ig.apply_device_corruption(
                    sol.resident, {"array": target, "index": 2, "bit": 4})
                sol.resident.rebind(problem)
            return problem

        sol.resident.refresh = refresh_then_flip
        svc.api.submit_pod(PodEvent(pod_id=f"extra_{i}"))
        svc.run_round(svc.api.poll_pod_batch(0.005))
        counts.append(dict(sol.integrity_counts))
    sol.resident.refresh = refresh
    return svc, counts


def test_placement_gate_runs_every_rung():
    """The placement solver's integrity gate on the port's resident
    service: a flip in a problem row heals by re-scatter, in the plan by
    re-upload, in the solver's warm flow by the full_build rung; the
    counts land in integrity_counts, and the placements stay those of a
    clean run."""
    from ksched_tpu_torch.drivers.service import live_placements

    clean, clean_counts = _gate_run([None] * 3)
    svc, counts = _gate_run(["cap", "p_sign", "warm_flow"])
    assert clean_counts[-1] == {}
    assert counts == [
        {"divergences": 1, "repair_rescatter": 1},
        {"divergences": 2, "repair_rescatter": 1, "repair_reupload": 1},
        {"divergences": 3, "repair_rescatter": 1, "repair_reupload": 1,
         "repair_full_build": 1},
    ]
    svc.scheduler.solver.resident.parity_check()
    assert live_placements(svc) == live_placements(clean)


def test_parity_checks_raise_structured_integrity_errors():
    _jres, tres = _twins()
    ig.apply_device_corruption(tres, {"array": "cost", "index": 2, "bit": 9})
    with pytest.raises(ig.IntegrityError) as exc:
        tres.parity_check()
    err = exc.value
    assert isinstance(err, AssertionError) and "device mirror cost" in str(err)
    assert err.indices and len(err.indices) <= ig.DIFF_BOUND
    assert len(err.expected) == len(err.found) == len(err.indices)
    st = tres.state
    live = next(iter(st._arc_slot.values()))
    st.plan.p_sign[st.plan.pos_fwd[live]] = 0
    with pytest.raises(ig.IntegrityError, match="slot-plan invariant"):
        st.plan.check_invariants()
    err = ig.bounded_diff("x", np.arange(100, dtype=np.int32),
                          np.arange(1, 101, dtype=np.int32))
    assert len(err.indices) == ig.DIFF_BOUND and "100 row(s)" in str(err)


# -- WAL framing -----------------------------------------------------------

RECS = [("meta", b'{"version":1}'), ("core", b"x" * 1000), ("warm", b"y" * 64)]


def test_wal_bytes_equal_the_jax_package(tmp_path):
    a, b = str(tmp_path / "t.wal"), str(tmp_path / "j.wal")
    ig.write_records(a, RECS)
    jig.write_records(b, RECS)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert ig.read_records(a) == jig.read_records(a) == RECS


@pytest.mark.parametrize("mode,kind", [("wal_drop", "seq_gap"), ("wal_dup", "seq_dup"),
                                       ("wal_torn", "truncated")])
def test_wal_corruption_classified(tmp_path, mode, kind):
    p = str(tmp_path / "m.wal")
    kinds = []
    for seed in range(12):
        ig.write_records(p, RECS)
        ig.corrupt_wal_file(p, mode, np.random.default_rng(seed))
        damaged = open(p, "rb").read()
        jig.write_records(p, RECS)
        jig.corrupt_wal_file(p, mode, np.random.default_rng(seed))
        assert open(p, "rb").read() == damaged
        with pytest.raises(ig.WALCorrupted) as exc:
            ig.read_records(p)
        kinds.append(exc.value.kind)
    assert kind in kinds


def test_wal_bad_magic_and_crc(tmp_path):
    p = str(tmp_path / "m.wal")
    with open(p, "wb") as f:
        f.write(b"not a wal at all")
    with pytest.raises(ig.WALCorrupted) as exc:
        ig.read_records(p)
    assert exc.value.kind == "bad_magic"
    ig.write_records(p, RECS)
    data = bytearray(open(p, "rb").read())
    data[-20] ^= 0xFF  # inside the last payload
    open(p, "wb").write(bytes(data))
    with pytest.raises(ig.WALCorrupted) as exc:
        ig.read_records(p)
    assert exc.value.kind == "crc"
