"""The port's tenant policy (tenancy/manager.py): admission caps, pow2
buckets, fairness rotation and quarantine, the manager cases of
tests/test_tenancy.py, and a seeded script of admissions, evictions and
rounds through both packages' managers with equal decisions."""

import numpy as np
import pytest

from ksched_tpu_torch.obs.metrics import Registry, scoped_registry
from ksched_tpu_torch.tenancy import AdmissionError, AdmissionPolicy, TenantManager

jt = pytest.importorskip("ksched_tpu.tenancy")


class _FakeLane:
    quarantined = False


def test_admission_caps():
    mgr = TenantManager(AdmissionPolicy(max_tenants=2, max_nodes=1 << 10, max_arcs=1 << 12))
    mgr.admit("a", 100, 200)
    with pytest.raises(AdmissionError):
        mgr.admit("a", 100, 200)  # duplicate
    with pytest.raises(AdmissionError):
        mgr.admit("big", 1 << 11, 100)  # size cap
    mgr.admit("b", 100, 200)
    with pytest.raises(AdmissionError):
        mgr.admit("c", 100, 200)  # max_tenants
    mgr.evict("b")
    mgr.admit("c", 100, 200)


def test_admission_bucket_lane_cap():
    mgr = TenantManager(AdmissionPolicy(max_lanes_per_bucket=2))
    mgr.admit("a", 100, 200)
    mgr.admit("b", 100, 200)
    with pytest.raises(AdmissionError):
        mgr.admit("c", 100, 200)  # same pow2 bucket, full
    mgr.admit("d", 1000, 2000)  # a different bucket still admits
    assert mgr.accounts["a"].bucket == (128, 256)
    assert mgr.accounts["d"].bucket == (1024, 2048)


def test_fairness_rotation():
    mgr = TenantManager()
    for t in ("a", "b", "c"):
        mgr.admit(t, 10, 10)
    assert mgr.order(0) == ["a", "b", "c"]
    assert mgr.order(1) == ["b", "c", "a"]
    assert mgr.order(2) == ["c", "a", "b"]
    assert mgr.order(3) == ["a", "b", "c"]


def test_quarantine_after_streak_and_release():
    mgr = TenantManager(AdmissionPolicy(quarantine_after=2, quarantine_rounds=3))
    lane = _FakeLane()
    mgr.admit("a", 10, 10)
    mgr.register_lane("a", lane)
    mgr.note_round("a", warm_escape=True)
    assert not lane.quarantined
    mgr.note_round("a", warm_escape=True)  # streak hits 2 -> quarantine
    assert lane.quarantined
    for _ in range(3):
        mgr.note_round("a")
    assert not lane.quarantined  # window served, released
    mgr.note_round("a", noop=True)
    mgr.note_round("a")
    mgr.note_round("a", noop=True)
    assert not lane.quarantined
    with pytest.raises(AdmissionError):
        mgr.register_lane("nobody", _FakeLane())


def test_metrics_count_admissions_refusals_and_quarantines():
    with scoped_registry(Registry()) as reg:
        mgr = TenantManager(AdmissionPolicy(max_tenants=1, quarantine_after=1))
        mgr.admit("a", 10, 10)
        with pytest.raises(AdmissionError):
            mgr.admit("b", 10, 10)
        mgr.note_round("a", noop=True)
    assert reg.value("ksched_tenants") == 1
    assert reg.value("ksched_tenant_admission_rejected_total", reason="max_tenants") == 1
    assert reg.value("ksched_tenant_quarantines_total") == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_script_decides_as_the_jax_package(seed):
    """Admit, evict and note rounds in a seeded order through both
    managers: the same refusals, accounts, orders and quarantine flags
    after every step."""
    rng = np.random.default_rng(seed)
    policy = dict(max_tenants=6, max_nodes=1 << 12, max_arcs=1 << 14,
                  max_lanes_per_bucket=2, quarantine_after=2, quarantine_rounds=3)
    mine, ref = TenantManager(AdmissionPolicy(**policy)), jt.TenantManager(jt.AdmissionPolicy(**policy))
    lanes = {}
    for step in range(200):
        op = rng.integers(0, 4)
        tid = f"t{int(rng.integers(0, 9))}"
        if op == 0:
            n, m = int(rng.integers(1, 1 << 13)), int(rng.integers(1, 1 << 15))
            outs = []
            for mgr, err in ((mine, AdmissionError), (ref, jt.AdmissionError)):
                try:
                    outs.append(mgr.admit(tid, n, m).bucket)
                except err as e:
                    outs.append(str(e))
            assert outs[0] == outs[1], step
            if tid in mine.accounts and tid not in lanes:
                lanes[tid] = (_FakeLane(), _FakeLane())
                mine.register_lane(tid, lanes[tid][0])
                ref.register_lane(tid, lanes[tid][1])
        elif op == 1:
            mine.evict(tid)
            ref.evict(tid)
            lanes.pop(tid, None)
        else:
            noop, esc = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
            mine.note_round(tid, noop=noop, warm_escape=esc)
            ref.note_round(tid, noop=noop, warm_escape=esc)
        assert mine.order(step) == ref.order(step), step
        for t, a in mine.accounts.items():
            b = ref.accounts[t]
            assert (a.bucket, a.rounds, a.noop_rounds, a.warm_escapes, a.bad_streak,
                    a.quarantined_until, a.quarantine_count) == (
                b.bucket, b.rounds, b.noop_rounds, b.warm_escapes, b.bad_streak,
                b.quarantined_until, b.quarantine_count), step
        for t, (x, y) in lanes.items():
            assert x.quarantined == y.quarantined, step
