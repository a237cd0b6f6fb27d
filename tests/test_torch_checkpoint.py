"""The port's checkpoints (ksched_tpu_torch/runtime/checkpoint.py)
against the JAX package's, on the CPU with tolerance 0: a device
checkpoint that the JAX package saved loads in the port, and the next
rounds equal the JAX package's; the service's checkpoint and warm
restore (the CRC-framed manifest and CsrSolver's warm state) make the
first solve after a restore bit-identical to the run that was never
killed; damaged inputs fall back or raise as in the JAX package; the
event-path and BulkCluster checkpoints round-trip."""

import os
import pickle
import warnings

import numpy as np
import pytest

from ksched_tpu.costmodels import coco
from ksched_tpu.costmodels.device_costs import coco_device_cost_fn as jax_coco
from ksched_tpu.runtime import checkpoint as jck
from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster as JaxCluster
from ksched_tpu_torch.cli import SERVICE_CHECKPOINT_VERSION, SchedulerService
from ksched_tpu_torch.cluster import SyntheticClusterAPI
from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service
from ksched_tpu_torch.runtime import checkpoint as ck
from ksched_tpu_torch.runtime.integrity import corrupt_wal_file
from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster
from ksched_tpu_torch.solver.select import make_backend

M = 40
PEN = np.random.default_rng(7).integers(0, 40, (M, 4)).astype(np.int64)
TIERS = dict(num_machines=M, pus_per_machine=4, slots_per_pu=4, num_jobs=4,
             num_task_classes=4, task_capacity=1024, unsched_cost=coco.UNSCHEDULED_COST,
             ec_cost=0, supersteps=1 << 16, preemption=True, continuation_discount=8,
             decode_width=256, track_realized_cost=True, preempt_every=4,
             preempt_global_every=16)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert y.dtype == x.dtype, k
        np.testing.assert_array_equal(y, x, err_msg=k)


@pytest.mark.parametrize("steady_before", [0, 6])
def test_jax_device_checkpoint_loads_in_the_port(tmp_path, steady_before):
    """The three-tier cluster (hybrid carry included) saved by the JAX
    package after its fill and some steady rounds; the port's loaded
    cluster then runs 20 steady rounds equal to the JAX package's."""
    jc = JaxCluster(class_cost_fn=jax_coco(PEN), **TIERS)
    rng = np.random.default_rng(1)
    jc.add_tasks(400, rng.integers(0, 4, 400).astype(np.int32),
                 rng.integers(0, 4, 400).astype(np.int32))
    jc.fetch_stats(jc.round())
    if steady_before:
        jc.fetch_stats(jc.run_steady_rounds(steady_before, 0.05, 20, seed=3))
    path = str(tmp_path / "jax.npz")
    jck.save_device_checkpoint(jc, path)
    tc = ck.load_device_checkpoint(path, class_cost_fn=coco_device_cost_fn(PEN),
                                   device="cpu")
    assert tc.device.type == "cpu" and tc.hybrid_preempt
    _same(jc.fetch_state(), tc.fetch_state())
    assert (tc._hyb_k, tc._hyb_kg) == (int(jc._hyb_k), int(jc._hyb_kg))
    _same(jc.fetch_stats(jc.run_steady_rounds(20, 0.05, 20, seed=5)),
          tc.fetch_stats(tc.run_steady_rounds(20, 0.05, 20, seed=5)))
    _same(jc.fetch_state(), tc.fetch_state())
    # the port's own save loads back equal, and in the JAX package too
    path2 = str(tmp_path / "port.npz")
    ck.save_device_checkpoint(tc, path2)
    _same(tc.fetch_state(), ck.load_device_checkpoint(
        path2, class_cost_fn=coco_device_cost_fn(PEN), device="cpu").fetch_state())
    _same(tc.fetch_state(), jck.load_device_checkpoint(
        path2, class_cost_fn=jax_coco(PEN)).fetch_state())


def test_group_mode_device_checkpoint(tmp_path):
    """Group mode: the GroupSpec arrays ride the checkpoint."""
    kw = dict(num_machines=8, pus_per_machine=2, slots_per_pu=2, num_jobs=2,
              task_capacity=128, num_groups=16, supersteps=1 << 14)
    jc = JaxCluster(**kw)
    rng = np.random.default_rng(5)
    groups = dict(cls=np.zeros(16, np.int32), job=(np.arange(16) % 2).astype(np.int32),
                  e=rng.integers(0, 4, 16).astype(np.int32),
                  u=rng.integers(8, 12, 16).astype(np.int32),
                  pref_w=np.full((16, 8), -1, np.int32))
    jc.set_groups(**groups)
    jc.add_tasks(40, rng.integers(0, 2, 40).astype(np.int32),
                 groups=rng.integers(0, 16, 40).astype(np.int32))
    jc.fetch_stats(jc.round())
    path = str(tmp_path / "g.npz")
    jck.save_device_checkpoint(jc, path)
    tc = ck.load_device_checkpoint(path, device="cpu")
    _same(jc.fetch_state(), tc.fetch_state())
    _same({k: np.asarray(v) for k, v in jc.groups._asdict().items()},
          {k: v.numpy() for k, v in tc.groups._asdict().items()})
    for c in (jc, tc):
        c.add_tasks(6, np.zeros(6, np.int32), groups=np.arange(6, dtype=np.int32))
    _same(jc.fetch_stats(jc.round()), tc.fetch_stats(tc.round()))
    _same(jc.fetch_state(), tc.fetch_state())


def test_device_checkpoint_rejects_other_kinds(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, a=np.zeros(3))
    with pytest.raises(ValueError, match="not a device_bulk checkpoint"):
        ck.load_device_checkpoint(path, device="cpu")


# -- the service: checkpoint and warm restore -------------------------------

SMALL = dict(machines=6, pus_per_core=2, slots=8, pods=40, rounds=5, arrivals=6,
             churn=0.1, backend="jax", device_resident=True, audit_every=1)


@pytest.mark.parametrize("after", [1, 3])
def test_warm_restore_is_bit_identical(after):
    """A kill-and-restore through the warm manifest after round `after`:
    every later round equals the never-killed run (placements, bound,
    supersteps), the first solve after it is warm on a delta-sized
    upload, and both equal the JAX package's restored run."""
    from torch_service_reference import jax_package

    clean = run_service(package("cpu"), ServiceConfig(**SMALL))
    cfg = ServiceConfig(**SMALL, restore_after=after)
    got = run_service(package("cpu"), cfg)
    assert got["restored_warm"] is True
    keep = ("bound", "placed", "sha256", "solver_work")
    rows = [[r[k] for k in keep] for r in got["rounds"]]
    assert rows == [[r[k] for k in keep] for r in clean["rounds"]]
    jax_rows = [[r[k] for k in keep] for r in run_service(jax_package(), cfg)["rounds"]]
    assert rows == jax_rows
    sol = got["service"].scheduler.solver
    assert sol.resident.last_upload_kind == "delta"
    assert ck.find_jax_solver(sol.backend).last_warm_scope in ("warm", "fresh")


def _checkpointed(tmp_path):
    got = run_service(package("cpu"), ServiceConfig(**{**SMALL, "rounds": 2}))
    svc = got["service"]
    path = str(tmp_path / "svc.ckpt")
    svc.save_checkpoint(path)
    return svc, path


def _restore(svc, path, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new = SchedulerService.restore(
            svc.api, path, backend=make_backend("jax", device="cpu"),
            backend_name="jax", device_resident=True, device="cpu", **kw)
    return new, [str(w.message) for w in caught]


@pytest.mark.parametrize("mode", ["wal_drop", "wal_dup", "wal_torn"])
def test_corrupted_manifest_falls_back_cold(tmp_path, mode):
    svc, path = _checkpointed(tmp_path)
    corrupt_wal_file(path + ".wal", mode, np.random.default_rng(1))
    new, msgs = _restore(svc, path)
    assert not new.restored_warm and new.backlog_dirty
    assert any("falling back to cold event replay" in m for m in msgs)
    assert dict(new.scheduler.task_bindings) == dict(svc.scheduler.task_bindings)
    assert new.pod_to_task == svc.pod_to_task


def test_stale_or_missing_manifest(tmp_path):
    svc, path = _checkpointed(tmp_path)
    stale = open(path + ".wal", "rb").read()
    svc.save_checkpoint(path)  # a new nonce
    open(path + ".wal", "wb").write(stale)
    new, msgs = _restore(svc, path)
    assert not new.restored_warm and any("different checkpoint" in m for m in msgs)
    os.remove(path + ".wal")
    new, _ = _restore(svc, path)
    assert not new.restored_warm
    assert dict(new.scheduler.task_bindings) == dict(svc.scheduler.task_bindings)


def test_damaged_inputs_raise_distinct_errors(tmp_path):
    svc, path = _checkpointed(tmp_path)
    bad = str(tmp_path / "garbage.ckpt")
    open(bad, "wb").write(b"\x00not a pickle")
    with pytest.raises(ck.CheckpointDamaged):
        _restore(svc, bad)
    no_version = str(tmp_path / "nov.ckpt")
    with open(no_version, "wb") as f:
        pickle.dump({"x": 1}, f)
    with pytest.raises(ck.CheckpointDamaged, match="no version"):
        _restore(svc, no_version)
    state = pickle.load(open(path, "rb"))
    assert state["version"] == SERVICE_CHECKPOINT_VERSION
    state["version"] = 99
    future = str(tmp_path / "future.ckpt")
    with open(future, "wb") as f:
        pickle.dump(state, f)
    with pytest.raises(ck.CheckpointVersionError):
        _restore(svc, future)
    os.remove(path + ".sched")
    with pytest.raises(ck.CheckpointMissing):
        _restore(svc, path)


def test_export_import_warm_state_round_trip():
    """CsrSolver's warm state leaves as host arrays and re-enters a
    fresh solver (on the mirror's device with `resident`)."""
    got = run_service(package("cpu"), ServiceConfig(**{**SMALL, "rounds": 1}))
    csr = ck.find_jax_solver(got["service"].scheduler.solver.backend)
    warm = csr.export_warm_state()
    assert set(warm) == {"prev", "prev_p", "prev_src", "prev_dst", "key_solved"}
    other = make_backend("jax", device="cpu")
    other.import_warm_state(warm, resident=True)
    np.testing.assert_array_equal(other._prev_dev.numpy(), warm["prev"])
    np.testing.assert_array_equal(other._prev_p.numpy(), warm["prev_p"])
    assert other._key_solved == warm["key_solved"]
    other.import_warm_state(warm)
    assert other._prev_dev is None and other._prev_src_host is not None
    assert make_backend("jax", device="cpu").export_warm_state() is None


# -- the event-path and BulkCluster checkpoints ---------------------------------


def test_scheduler_checkpoint_roundtrip(tmp_path):
    from ksched_tpu_torch.data import TaskState
    from ksched_tpu_torch.drivers import add_job, build_cluster

    sched, _rmap, jmap, tmap, _root = build_cluster(
        num_machines=3, pus_per_core=2, max_tasks_per_pu=1,
        backend=make_backend("ref", device="cpu"))
    add_job(sched, jmap, tmap, num_tasks=4)
    sched.schedule_all_jobs()
    before = dict(sched.get_task_bindings())
    path = str(tmp_path / "sched.ckpt")
    ck.save_scheduler(sched, path)
    sched2, _rmap2, jmap2, tmap2 = ck.restore_scheduler(
        path, backend=make_backend("ref", device="cpu"))
    assert dict(sched2.get_task_bindings()) == before
    assert all(tmap2.find(t).state == TaskState.RUNNING for t in before)
    assert sched2.gm.sink_node.excess == -len(sched2.gm.task_to_node)
    add_job(sched2, jmap2, tmap2, num_tasks=2)
    assert sched2.schedule_all_jobs()[0] == 2


def test_bulk_checkpoint_roundtrip(tmp_path):
    from ksched_tpu_torch.scheduler.bulk import BulkCluster
    from ksched_tpu_torch.solver.native import NativeSolver

    c = BulkCluster(num_machines=4, pus_per_machine=2, slots_per_pu=2, num_jobs=2,
                    backend=NativeSolver(), task_capacity=64)
    rng = np.random.default_rng(0)
    c.add_tasks(10, rng.integers(0, 2, 10).astype(np.int32))
    c.round()
    path = str(tmp_path / "bulk.npz")
    ck.save_bulk_checkpoint(c, path)
    c2 = ck.load_bulk_checkpoint(path, backend=NativeSolver())
    assert (c2.task_pu == c.task_pu).all() and c2.num_placed_tasks == c.num_placed_tasks
    c2.add_tasks(6, rng.integers(0, 2, 6).astype(np.int32))
    assert len(c2.round().placed_tasks) == 6


def test_restores_on_pow2_growth_rounds_match_the_jax_package():
    """The recovery soak at seed 11 on 6 x 8 slots with a restore every
    64 rounds: both restores land on a pow2 bucket growth round, where
    the warm manifest's key remap meets a grown plan. The port's soak
    equals the JAX package's (placements, bindings, flips, divergences,
    repairs, restores) and holds the strict delta-kind asserts on as
    many recovery rounds, none; so the recovery arm's check fails in
    the port as it does in the JAX package's tools/soak.py."""
    import soak as jsoak  # tools/, put on sys.path by torch_service_reference
    from ksched_tpu_torch.drivers import soak as tsoak
    from torch_service_reference import soak_args

    quiet = lambda *a, **k: None  # noqa: E731
    kw = dict(rounds=128, chunk=32, seed=11, machines=6, slots=8, chaos_restore_every=64,
              corruption=True, device_resident=True, device="cpu")
    got = tsoak.run_chaos_soak(soak_args(**kw), quiet)
    want = jsoak.run_chaos_soak(soak_args(**kw), quiet)
    assert tsoak.soak_summary(got) == tsoak.soak_summary(want)
    assert got["recovery_strict"] == want["recovery_strict"] == 0
    assert got["restores"] == got["warm_restores"] == 2
    assert got["device_flips"] > 0
    with pytest.raises(AssertionError, match="no recovery round held the strict"):
        tsoak.chaos_main(soak_args(**kw, verify_recovery=True), quiet)
