"""The port's multi-tenant service (tenancy/service.py) and the split
round of SchedulerService (cli.py dispatch_round/complete_round), the
service cases of tests/test_tenancy.py, each tenant's bindings, solver
work and scheduled counts equal to the JAX package's MultiTenantService
on the same seeds; and cli.main's --tenants."""

import contextlib
import io
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from ksched_tpu_torch.obs.metrics import Registry

jt = pytest.importorskip("ksched_tpu.tenancy")


def _port():
    from ksched_tpu_torch.cluster import PodEvent
    from ksched_tpu_torch.runtime.chaos import ChaosPolicy, FaultInjector
    from ksched_tpu_torch.tenancy import MultiTenantService

    return SimpleNamespace(
        mts=lambda **kw: MultiTenantService(device="cpu", **kw), PodEvent=PodEvent,
        ChaosPolicy=ChaosPolicy, FaultInjector=FaultInjector, Registry=Registry)


def _jax():
    from ksched_tpu.cluster import PodEvent
    from ksched_tpu.obs.metrics import Registry as JaxRegistry
    from ksched_tpu.runtime.chaos import ChaosPolicy, FaultInjector

    return SimpleNamespace(
        mts=jt.MultiTenantService, PodEvent=PodEvent, ChaosPolicy=ChaosPolicy,
        FaultInjector=FaultInjector, Registry=JaxRegistry)


def _drive_cells(pkg, tenant_ids, chaos_on=None, rounds=5, registry=None,
                 resident=False):
    reg = registry if registry is not None else pkg.Registry()
    mts = pkg.mts(registry=reg, pipeline=True, device_resident=resident)
    cells = {}
    for tid in tenant_ids:
        inj = None
        if tid == chaos_on:
            inj = pkg.FaultInjector(pkg.ChaosPolicy(
                seed=3, solver_fault_prob=0.5, solver_total_outage_prob=0.3))
        cells[tid] = mts.add_tenant(tid, machines=3, pus_per_core=2, slots=4,
                                    seed=sum(map(ord, tid)), injector=inj)
    rngs = {tid: np.random.default_rng(sum(map(ord, tid))) for tid in tenant_ids}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(rounds):
            for tid, cell in cells.items():
                for j in range(int(rngs[tid].integers(0, 3))):
                    cell.api.submit_pod(pkg.PodEvent(pod_id=f"{tid}_pod_{r}_{j}"))
            mts.run_round(now=float(r))
        mts.drain()
    out = {}
    for tid in tenant_ids:
        recs = cells[tid].svc.tracer.records
        out[tid] = dict(
            bindings=dict(cells[tid].api.bindings()),
            work=[rec.solver_work for rec in recs],
            scheduled=[rec.num_scheduled for rec in recs],
            rungs=[rec.solver_rung for rec in recs],
            faults=sum(sum(r.faults_injected.values()) for r in recs),
            degr=sum(r.degradations for r in recs),
            noops=sum(1 for r in recs if r.noop_round),
            tenants={r.tenant for r in recs},
        )
    return out, mts


def test_service_isolated_parity_and_jax_parity():
    """Each cell of a 3-tenant process schedules as the same cell alone
    in its own process, and as the JAX package's 3-tenant process."""
    multi, _ = _drive_cells(_port(), ["a", "b", "c"])
    ref, _ = _drive_cells(_jax(), ["a", "b", "c"])
    assert multi == ref
    for tid in ("a", "b", "c"):
        solo, _ = _drive_cells(_port(), [tid])
        for key in ("bindings", "work", "scheduled"):
            assert solo[tid][key] == multi[tid][key], (tid, key)
        assert multi[tid]["tenants"] == {tid}


def test_service_chaos_zero_cross_tenant_interference():
    """Chaos on tenant a: its lane degrades and NOOPs as the JAX
    package's does; every other cell's records carry zero faults,
    degradations and NOOPs, and its placements equal its solo run's."""
    multi, _ = _drive_cells(_port(), ["a", "b", "c"], chaos_on="a", rounds=8)
    ref, _ = _drive_cells(_jax(), ["a", "b", "c"], chaos_on="a", rounds=8)
    assert multi == ref
    assert multi["a"]["faults"] > 0 and multi["a"]["degr"] > 0
    for tid in ("b", "c"):
        assert multi[tid]["faults"] == multi[tid]["degr"] == multi[tid]["noops"] == 0
        solo, _ = _drive_cells(_port(), [tid], rounds=8)
        assert solo[tid]["bindings"] == multi[tid]["bindings"]
        assert solo[tid]["work"] == multi[tid]["work"]


def test_service_per_tenant_registry_accounting():
    reg = Registry()
    out, mts = _drive_cells(_port(), ["a", "b"], rounds=4, registry=reg)
    for tid in ("a", "b"):
        total = sum(reg.value("ksched_rounds_total", tenant=tid, kind=k)
                    for k in ("sched", "idle", "noop"))
        assert total == len(out[tid]["work"])
    assert reg.value("ksched_tenants") == 2
    assert reg.value("ksched_tenant_batch_flushes_total") > 0
    assert set(mts.tenant_summary()) == {"a", "b"}


def test_service_device_resident_cells_match_host_cells():
    host, _ = _drive_cells(_port(), ["a", "b"], resident=False)
    resident, _ = _drive_cells(_port(), ["a", "b"], resident=True)
    for tid in ("a", "b"):
        assert host[tid]["bindings"] == resident[tid]["bindings"]
        assert host[tid]["work"] == resident[tid]["work"]


def test_no_work_split_rounds_record_as_idle_sweeps():
    pkg = _port()
    mts = pkg.mts(registry=Registry(), pipeline=True)
    cell = mts.add_tenant("a", machines=2, pus_per_core=2, slots=4, seed=1)
    cell.api.submit_pod(pkg.PodEvent(pod_id="a_p0"))
    mts.run_round(now=0.0)
    for r in range(3):
        mts.run_round(now=1.0 + r)
    mts.drain()
    recs = cell.svc.tracer.records
    assert [r.solver_rung for r in recs] == [0, -1, -1, -1]
    s = cell.svc.tracer.summary()
    assert s["rounds"] == 1 and s["idle_rounds"] == 3


def test_service_post_failure_does_not_wedge_the_fleet():
    pkg = _port()
    mts = pkg.mts(registry=Registry(), pipeline=True)
    cells = {t: mts.add_tenant(t, machines=2, pus_per_core=2, slots=4, seed=ord(t[0]))
             for t in ("a", "b")}
    for t, c in cells.items():
        for j in range(2):
            c.api.submit_pod(pkg.PodEvent(pod_id=f"{t}_p{j}"))
    mts.run_round(now=0.0)
    fail = {"n": 0}
    real_assign = cells["a"].api.assign_bindings

    def flaky(bindings):
        fail["n"] += 1
        raise OSError("control plane hiccup")

    cells["a"].api.assign_bindings = flaky
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mts.run_round(now=1.0)
    assert fail["n"] == 1
    assert any("queued for retry" in str(w.message) for w in caught)
    cells["a"].api.assign_bindings = real_assign
    mts.run_round(now=2.0)
    mts.drain()
    assert len(cells["a"].api.bindings()) == 2
    assert len(cells["b"].api.bindings()) == 2


def test_service_admission_error_rolls_back():
    from ksched_tpu_torch.tenancy import AdmissionError, AdmissionPolicy

    mts = _port().mts(registry=Registry(), policy=AdmissionPolicy(max_tenants=1))
    mts.add_tenant("a", machines=2, slots=2)
    with pytest.raises(AdmissionError):
        mts.add_tenant("b", machines=2, slots=2)
    assert list(mts.cells) == ["a"]
    mts.remove_tenant("a")
    mts.add_tenant("b", machines=2, slots=2)
    assert list(mts.cells) == ["b"]


def test_tenant_checkpoint_keeps_the_cell_stream(tmp_path):
    """save_tenant_checkpoint writes the cell's checkpoint under its
    parked rng stream: the fleet's placements go on as without it."""
    def run(save):
        pkg = _port()
        mts = pkg.mts(registry=Registry(), pipeline=False)
        cells = {t: mts.add_tenant(t, machines=2, pus_per_core=2, slots=4, seed=ord(t))
                 for t in ("a", "b")}
        for r in range(3):
            for t, c in cells.items():
                c.api.submit_pod(pkg.PodEvent(pod_id=f"{t}_p{r}"))
            mts.run_round(now=float(r))
            if save and r == 1:
                mts.save_tenant_checkpoint("a", str(tmp_path / "a.ckpt"))
        return {t: dict(c.api.bindings()) for t, c in cells.items()}, mts

    plain, _ = run(False)
    saved, mts = run(True)
    assert saved == plain
    assert mts.manager.accounts["a"].extra["checkpoint"].endswith("a.ckpt")
    assert (tmp_path / "a.ckpt").exists()


@pytest.mark.parametrize("pipeline", [False, True])
def test_split_round_equals_run_round(pipeline):
    """dispatch_round + complete_round is one run_round on a round with
    runnable work: the same bindings, records and solver work round by
    round. (A split round with nothing runnable records an idle sweep,
    test_no_work_split_rounds_record_as_idle_sweeps.)"""
    from ksched_tpu_torch.cli import SchedulerService
    from ksched_tpu_torch.cluster import PodEvent, SyntheticClusterAPI
    from ksched_tpu_torch.runtime import RoundTracer
    from ksched_tpu_torch.solver.select import make_backend
    from ksched_tpu_torch.utils import seed_rng

    def run(split):
        seed_rng(5)
        api = SyntheticClusterAPI()
        svc = SchedulerService(api, max_tasks_per_pu=4, backend=make_backend("jax", device="cpu"),
                               backend_name="jax", tracer=RoundTracer(), pipeline=pipeline,
                               device="cpu")
        svc.init_topology(fake_machines=3, pus_per_core=2)
        rng = np.random.default_rng(9)
        for r in range(5):
            for j in range(int(rng.integers(1, 5))):
                api.submit_pod(PodEvent(pod_id=f"p{r}_{j}"))
            if r == 3:
                bound = sorted(svc.pod_to_task)[:2]
                for p in bound:
                    svc.complete_pod(p)
            pods = api.poll_pod_batch(0.005)
            if split:
                svc.dispatch_round(pods)
                svc.complete_round(now=float(r))
            else:
                svc.run_round(pods, now=float(r))
            svc.flush_pending_bindings()
        recs = [(x.num_scheduled, x.solver_work, x.solver_rung) for x in svc.tracer.records]
        return dict(api.bindings()), recs

    assert run(True) == run(False)


def test_split_round_latch():
    from ksched_tpu_torch.cli import SchedulerService
    from ksched_tpu_torch.cluster import SyntheticClusterAPI
    from ksched_tpu_torch.solver.select import make_backend

    svc = SchedulerService(SyntheticClusterAPI(), max_tasks_per_pu=2,
                           backend=make_backend("jax", device="cpu"), device="cpu")
    svc.init_topology(fake_machines=2, pus_per_core=1)
    with pytest.raises(RuntimeError, match="no split round"):
        svc.complete_round()
    assert svc.dispatch_round([]) is False
    with pytest.raises(RuntimeError, match="already in flight"):
        svc.dispatch_round([])
    svc.complete_round()


def test_cli_tenants_binds_every_cell():
    from ksched_tpu_torch.cli import main as cli_main
    from ksched_tpu_torch.obs.metrics import scoped_registry

    err = io.StringIO()
    with contextlib.redirect_stderr(err), scoped_registry(Registry()):
        rc = cli_main(["--tenants", "3", "--podgen", "30", "-nm", "2", "--pus-per-core", "2",
                       "-mt", "4", "--device", "cpu"])
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("cell")]
    assert rc == 0 and len(lines) == 3, err.getvalue()
    assert all(ln.split()[1] == "bound=10" for ln in lines), lines
