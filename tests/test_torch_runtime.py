"""The port's runtime (ksched_tpu_torch/runtime: failure.py's heartbeat
monitor and round watchdog, trace.py's RoundTracer, chaos.py's fault
injector, degrade.py's ladder) against the JAX package's on the CPU:
the same seeded scenario through both packages' SchedulerService gives
the same heartbeat expiries, the same RoundTracer JSONL (the wall-clock
fields aside), the same fault schedule and the same ladder rung
sequence under each injected solver fault kind. Tolerance 0."""

import json
import time
import warnings

import numpy as np
import pytest

import ksched_tpu.cli as jcli
import ksched_tpu.cluster as jcluster
import ksched_tpu.runtime as jrt
import ksched_tpu.solver.select as jselect
import ksched_tpu.utils as jutils
import ksched_tpu_torch.cli as tcli
import ksched_tpu_torch.cluster as tcluster
import ksched_tpu_torch.runtime as trt
import ksched_tpu_torch.solver.select as tselect
import ksched_tpu_torch.utils as tutils
from ksched_tpu_torch.drivers.service import live_placements

PKGS = {
    "jax": (jcli, jcluster, jrt, jselect, jutils, {}),
    "port": (tcli, tcluster, trt, tselect, tutils, {"device": "cpu"}),
}


def _backend(pkg, name):
    select, kw = PKGS[pkg][3], PKGS[pkg][5]
    return select.make_backend(name, **kw)


def _service(pkg, policy=None, backend="auto", machines=6, pus=2, slots=8, **kw):
    cli, cluster, rt, _select, utils, dev = PKGS[pkg]
    utils.seed_rng(3)
    api = cluster.SyntheticClusterAPI()
    inj = rt.FaultInjector(rt.ChaosPolicy(**policy)) if policy is not None else None
    svc = cli.SchedulerService(api, max_tasks_per_pu=slots,
                               backend=_backend(pkg, backend), backend_name=backend,
                               injector=inj, tracer=rt.RoundTracer(), **kw, **dev)
    svc.init_topology(fake_machines=machines, pus_per_core=pus)
    return api, svc, inj


def _records(tracer):
    """The tracer's JSONL with the wall-clock fields zeroed."""
    out = []
    for line in tracer.to_jsonl().splitlines():
        rec = json.loads(line)
        rec["wall_time"] = 0.0
        rec["phases_ms"] = {k: 0.0 for k in rec["phases_ms"]}
        out.append(rec)
    return out


def _drive(pkg, policy, rounds=6, backend="auto", **kw):
    """Seeded pods through `rounds` hardened rounds; returns what the
    two packages must agree on."""
    api, svc, inj = _service(pkg, policy, backend=backend, **kw)
    cluster = PKGS[pkg][1]
    rng = np.random.default_rng(9)
    seq = 0
    ladder = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(rounds):
            if inj is not None:
                inj.begin_round(r)
            pods = []
            for _ in range(int(rng.integers(2, 9))):
                pods.append(cluster.PodEvent(pod_id=f"pod_{seq}", task_class=seq % 4))
                seq += 1
            svc.run_round(pods)
            lad = svc.ladder
            ladder.append((lad.last_rung, lad.last_rung_name, lad.last_degradations,
                           [x.get("kind") for x in lad.last_failure_reasons]))
    return {
        "records": _records(svc.tracer),
        "ladder": ladder,
        "rungs": svc.ladder.rung_names(),
        "faults": dict(inj.counters) if inj is not None else {},
        "noop": svc.noop_rounds,
        "placements": live_placements(svc),
        "bindings": api.bindings(),
    }


def _both(**kw):
    got = {pkg: _drive(pkg, **kw) for pkg in PKGS}
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key
    return got["port"]


@pytest.mark.parametrize("kind,backend", [("nonconverge", "auto"), ("exception", "auto"),
                                          ("nan_cost", "ref")])
def test_ladder_rungs_under_each_solver_fault(kind, backend):
    """Every round's configured rung faulted: the ladder steps to "jax"
    (the scan-CSR solve) every round, in both packages alike. (NaN'd
    costs through "auto": test_nan_cost_rejected_by_auto.)"""
    got = _both(backend=backend,
                policy=dict(seed=1, solver_fault_prob=1.0, solver_fault_kinds=(kind,)))
    assert got["rungs"] == [backend, "jax"] + (["cpu_ref"] if backend != "ref" else [])
    assert all(step[0] == 1 and step[1] == "jax" and step[2] == 1 for step in got["ladder"])
    assert got["faults"] == {f"solver_{kind}": 6}
    assert got["noop"] == 0 and len(got["placements"]) > 0


def test_nan_cost_rejected_by_auto():
    """The port's AutoSolver rejects NaN'd costs, so a nan_cost fault on
    the "auto" rung steps down to "jax" every round, placing as the JAX
    package's service configured with "jax" does. The JAX package's
    AutoSolver solves the
    poisoned problem on its dense rung instead (an objective of int64's
    minimum): a fault of the reference, left as it is."""
    policy = dict(seed=1, solver_fault_prob=1.0, solver_fault_kinds=("nan_cost",))
    port = _drive("port", policy)
    clean = _drive("jax", None, backend="jax")
    assert all(step[:3] == (1, "jax", 1) and step[3] == ["rejected_input"]
               for step in port["ladder"])
    assert port["placements"] == clean["placements"]
    assert port["faults"] == {"solver_nan_cost": 6}


def test_total_outage_is_a_noop_round_then_heals():
    """Every rung faulted on some rounds: NOOP rounds keep the previous
    placements, and the next clean round schedules the backlog."""
    got = _both(policy=dict(seed=4, solver_total_outage_prob=0.5,
                            solver_fault_kinds=("exception", "nonconverge")),
                rounds=8)
    noops = [r for r in got["records"] if r["noop_round"]]
    assert got["noop"] == len(noops) > 0
    assert all(r["solver_rung"] == -1 for r in noops)


def test_configured_jax_ladder_and_mixed_faults():
    """A configured "jax" rung gets no second jax rung; a mixed fault
    schedule (outages, drops, solver faults) is drawn alike."""
    got = _both(backend="jax",
                policy=dict(seed=7, solver_fault_prob=0.4, binding_drop_prob=0.2,
                            api_outage_prob=0.2))
    assert got["rungs"] == ["jax", "cpu_ref"]


def test_fault_schedule_streams_match():
    """The same seed draws the same schedule in both packages, domain by
    domain (numpy streams spawned from one seed)."""
    policy = dict(seed=12, api_outage_prob=0.3, binding_drop_prob=0.3,
                  machine_flap_prob=0.2, solver_fault_prob=0.3,
                  solver_total_outage_prob=0.1, device_corrupt_prob=0.5,
                  wal_corrupt_prob=0.5, http_error_prob=0.1, http_hang_prob=0.1,
                  http_latency_prob=0.2)
    logs = []
    for rt in (jrt, trt):
        inj = rt.FaultInjector(rt.ChaosPolicy(**policy))
        log = []
        for r in range(40):
            inj.begin_round(r)
            log.append((inj.outage_active(), inj.drop_binding(), inj.machine_silent(r % 5),
                        inj.solver_fault(0), inj.solver_fault(1),
                        inj.device_corruption(64, 256), inj.checkpoint_corruption(),
                        inj.http_fault("pods")))
        inj.quiesce()
        log.append((inj.solver_fault(0), inj.drop_binding()))
        logs.append((log, dict(inj.counters)))
    assert logs[0] == logs[1]
    with pytest.raises(ValueError, match="unknown solver fault kinds"):
        trt.ChaosPolicy(solver_fault_kinds=("meltdown",))


def test_build_ladder_rungs():
    """Rungs the configured backend covers are skipped, as in the JAX
    package; the lazy "jax" rung is built on the ladder's device."""
    for name, want in (("ref", ["ref", "jax"]), ("jax", ["jax", "cpu_ref"]),
                       ("native", ["native", "jax", "cpu_ref"])):
        got = [rt.build_degradation_ladder(_backend(pkg, name), name,
                                           **PKGS[pkg][5]).rung_names()
               for pkg, rt in (("jax", jrt), ("port", trt))]
        assert got == [want, want]
    lad = trt.build_degradation_ladder(_backend("port", "native"), "native", device="cpu")
    assert lad.device == "cpu" and lad._backend(1).device.type == "cpu"


# -- RoundTracer -----------------------------------------------------------


def test_round_tracer_jsonl_matches():
    """The same rounds give the same JSONL, the wall-clock fields aside,
    and the same summary of externally timed rounds."""
    got = _both(policy=dict(seed=2, binding_drop_prob=0.3, solver_fault_prob=0.3))
    assert len(got["records"]) == 6
    assert sum(r["num_scheduled"] for r in got["records"]) > 0
    sums = []
    for rt in (jrt, trt):
        tr = rt.RoundTracer(capacity=3)
        for i in range(5):
            tr.record_timed_round({"solve_s": 0.001 * (i + 1), "decode_s": 0.0005},
                                  num_scheduled=i, solver_work=10 * i)
        sums.append((tr.summary(), tr.summary("solve"),
                     [(r.round_index, r.num_scheduled) for r in tr.records]))
    assert sums[0] == sums[1]


def test_round_tracer_dump(tmp_path):
    tr = trt.RoundTracer()
    tr.record_timed_round({"solve_s": 0.002}, total_ms=3.0, num_scheduled=4)
    path = tmp_path / "rounds.jsonl"
    tr.dump(str(path))
    (rec,) = [json.loads(x) for x in path.read_text().splitlines()]
    assert rec["phases_ms"] == {"solve": 2.0, "total": 3.0} and rec["num_scheduled"] == 4


# -- heartbeats and the watchdog -------------------------------------------


def _machines(svc):
    return sorted(svc.machine_to_node)


def _heartbeat_run(pkg):
    """Machines beat at t=0; one goes silent; a sweep at t=40 expires it
    and requeues its tasks, which the next round re-places."""
    api, svc, _ = _service(pkg, machines=3, pus=1, slots=2)
    mon = svc.enable_heartbeats(machine_timeout_s=30.0, task_timeout_s=1e9)
    pods = [PKGS[pkg][1].PodEvent(pod_id=f"p{i}") for i in range(5)]
    svc.run_round(pods, now=0.0)
    mids = _machines(svc)
    for mid in mids:
        mon.record_machine_heartbeat(mid, now=0.0)
    silent = max(mids, key=lambda m: sum(
        1 for pu in svc.scheduler.task_bindings.values()
        if svc._find_parent_machine(pu) == m))
    for mid in mids:
        if mid != silent:
            mon.record_machine_heartbeat(mid, now=35.0)
    svc.run_round([], now=40.0)
    rec = svc.tracer.records[-1]
    stale = mon.record_machine_heartbeat(silent, now=41.0)
    return (rec.machines_lost, rec.tasks_failed, svc.backlog_dirty,
            len(svc.machine_to_node), stale, mon.stale_heartbeats,
            sorted(live_placements(svc).values()))


def test_heartbeat_expiry_matches():
    got = {pkg: _heartbeat_run(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    lost, failed, dirty, machines, stale, n_stale, _ = got["port"]
    assert (lost, failed, dirty, machines, stale, n_stale) == (1, 0, True, 2, False, 1)


def test_never_heartbeated_machines_not_monitored():
    _api, svc, _ = _service("port", machines=2, pus=1, slots=1)
    mon = svc.enable_heartbeats(machine_timeout_s=1.0)
    assert mon.check(now=1e6) == ([], [])


def test_round_watchdog_fires_and_counts():
    wd = trt.RoundWatchdog(0.05)
    with pytest.warns(RuntimeWarning, match="deadline"):
        with wd:
            time.sleep(0.15)
    assert wd.fired and wd.misses == 1
    with wd:
        pass
    assert not wd.fired and wd.misses == 1
    off = trt.RoundWatchdog(0.0)
    with off:
        time.sleep(0.01)
    assert not off.fired and off.misses == 0


@pytest.mark.parametrize("pipeline", [False, True])
def test_kernel_build_failure_raises_through_the_ladder(monkeypatch, tmp_path, pipeline):
    """A kernel that does not build fails the round: the ladder steps
    down for non-convergence, NaN costs and injected faults, never for
    a broken kernel. Here the dense rung of "auto" asks for the
    transport kernel's library as the card path does, and nvcc fails."""
    import ksched_tpu_torch.ops as ops
    from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service
    from ksched_tpu_torch.ops import build, transport

    monkeypatch.setattr(build, "_nvcc", lambda: "false")  # exits 1
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})

    def card_path(*args, **kw):
        transport._load("transport")
        raise AssertionError("the broken build loaded")

    monkeypatch.setattr(ops, "transport_solve", card_path)
    cfg = ServiceConfig(machines=6, pus_per_core=2, slots=8, pods=60, rounds=2,
                        arrivals=8, churn=0.1, classes=4, cost_model="whare",
                        backend="auto", pipeline=pipeline)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # no "degrading to"
        with pytest.raises(build.KernelError, match="transport: nvcc failed"):
            run_service(package("cpu"), cfg)
