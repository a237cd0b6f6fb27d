"""Checkpoint / resume.

The reference has none: all state is in-memory and restart means a cold
rebuild from the API server's world view (SURVEY §5). The rebuild keeps
that reconstructibility property AND makes it a feature:

- FlowScheduler checkpoints are the *host descriptors only* (topology
  roots, jobs/tasks, bindings) — exactly the world state an API server
  would hold. Restore replays them through the normal event API
  (register_resource / add_job / placement pinning), so the restored
  graph is rebuilt by the same code paths production uses, never by
  poking internals.
- BulkCluster checkpoints are the flat device-shaped arrays themselves,
  written as npz: restore is a buffer upload, the natural device-state
  checkpoint for the array path.

Port of ksched_tpu/runtime/checkpoint.py. The device checkpoint keeps
the JAX package's on-disk format (numpy arrays and JSON meta in one
npz), so a checkpoint that either package saved loads here.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data import JobState, TaskState
from ..scheduler import FlowScheduler
from ..utils import JobMap, ResourceMap, ResourceStatus, TaskMap, resource_id_from_string

CHECKPOINT_VERSION = 1
#: warm-restore manifest (the ".wal" companion): version of the framed
#: record stream save_warm_manifest writes
WARM_MANIFEST_VERSION = 1


class CheckpointError(RuntimeError):
    """Base for checkpoint load failures; subclasses are DISTINCT so a
    damaged sidecar, a missing companion, and a version mismatch each
    surface as their own actionable error (not one opaque crash)."""


class CheckpointDamaged(CheckpointError):
    """Truncated / garbage checkpoint bytes (unpicklable sidecar, torn
    write): the file exists but cannot be trusted."""


class CheckpointMissing(CheckpointError):
    """A required companion file of the checkpoint set is absent."""


class CheckpointVersionError(CheckpointError, ValueError):
    """The checkpoint was written by an incompatible version.
    ValueError subclass for callers that catch the bare ValueError an
    older version check raised."""
#: device checkpoints: version 2 = __meta_json__ typed meta; version 1 =
#: the older sorted-int64 __meta_keys__/__meta__ pair. Writers stamp 2;
#: the loader accepts both.
DEVICE_CHECKPOINT_VERSION = 2


# ---------------------------------------------------------------------------
# FlowScheduler (event-path) checkpoints
# ---------------------------------------------------------------------------


def atomic_pickle(state, path: str) -> None:
    """Pickle to a temp file and rename into place: a crash mid-write
    must leave the PREVIOUS checkpoint intact, not a truncated file
    where the last good one used to be (same discipline as the warm
    manifest's integrity.write_records)."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_scheduler(scheduler: FlowScheduler, path: str) -> None:
    """Snapshot the world state: topology roots, jobs (task trees ride
    along via root_task.spawned), and task→PU bindings."""
    jobs = {jid: jd for jid, jd in scheduler.job_map.items()}
    state = {
        "version": CHECKPOINT_VERSION,
        "coordinator": scheduler.resource_topology,
        "jobs": jobs,
        "bindings": dict(scheduler.task_bindings),
        "max_tasks_per_pu": scheduler.gm.max_tasks_per_pu,
    }
    atomic_pickle(state, path)


def restore_scheduler(
    path: str,
    cost_model_factory=None,
    backend=None,
    device_resident: bool = False,
) -> Tuple[FlowScheduler, ResourceMap, JobMap, TaskMap]:
    """Rebuild a scheduler from a checkpoint by replaying the event API.

    Placements are restored by pinning each bound task through the
    normal placement path, so bindings, resource stats, and graph state
    all agree — the same invariant a live scheduler maintains.
    """
    with open(path, "rb") as f:
        state = pickle.load(f)
    if state["version"] != CHECKPOINT_VERSION:
        raise ValueError(f"unsupported checkpoint version {state['version']}")

    resource_map = ResourceMap()
    job_map = JobMap()
    task_map = TaskMap()
    coordinator = state["coordinator"]

    def register_subtree(rtnd):
        rid = resource_id_from_string(rtnd.resource_desc.uuid)
        resource_map.insert(
            rid, ResourceStatus(descriptor=rtnd.resource_desc, topology_node=rtnd)
        )
        for ch in rtnd.children:
            register_subtree(ch)

    register_subtree(coordinator)
    # Clear runtime aggregates the replay will rebuild.
    for _, rs in resource_map.items():
        rs.descriptor.current_running_tasks = []
        rs.descriptor.num_running_tasks_below = 0
        rs.descriptor.num_slots_below = 0

    scheduler = FlowScheduler(
        resource_map,
        job_map,
        task_map,
        coordinator,
        max_tasks_per_pu=state["max_tasks_per_pu"],
        cost_model_factory=cost_model_factory,
        backend=backend,
        device_resident=device_resident,
    )
    # Each machine subtree under the coordinator goes through the normal
    # registration path (the constructor already registered the root).
    for machine in coordinator.children:
        scheduler.register_resource(machine)

    # Jobs + tasks. Previously-running tasks are reset to RUNNABLE so the
    # graph build creates their nodes; their recorded placements are then
    # re-pinned below (flipping them back to RUNNING).
    for jid, jd in state["jobs"].items():
        job_map.insert(jid, jd)
        stack = [jd.root_task] if jd.root_task else []
        while stack:
            td = stack.pop()
            task_map.insert(td.uid, td)
            stack.extend(td.spawned)
            if td.uid in state["bindings"] and td.state == TaskState.RUNNING:
                # CREATED (not RUNNABLE) so _compute_runnable_tasks_for_job
                # promotes it and registers it in the runnable set.
                td.state = TaskState.CREATED
                td.scheduled_to_resource = ""
        if jd.state not in (JobState.COMPLETED, JobState.FAILED, JobState.ABORTED):
            scheduler.add_job(jd)

    # Build task nodes WITHOUT a solve (no phantom placements), then
    # re-pin the recorded bindings through the normal placement path.
    jds = [
        jd
        for jd in scheduler.jobs_to_schedule.values()
        if scheduler._compute_runnable_tasks_for_job(jd)
    ]
    if jds:
        scheduler.gm.compute_topology_statistics(scheduler.gm.sink_node)
        scheduler.gm.add_or_update_job_nodes(jds)
    for task_id, pu_rid in state["bindings"].items():
        td = task_map.find(task_id)
        rs = resource_map.find(pu_rid)
        if td is None or rs is None:
            continue
        scheduler.handle_task_placement(td, rs.descriptor)
    return scheduler, resource_map, job_map, task_map


# ---------------------------------------------------------------------------
# BulkCluster (array-path) checkpoints
# ---------------------------------------------------------------------------

_BULK_ARRAYS = (
    "src", "dst", "cap", "cost", "excess", "node_type",
    "task_live", "task_job", "task_class", "task_pu",
    "pu_running", "machine_census", "machine_enabled",
)


def save_bulk_checkpoint(cluster, path: str) -> None:
    """Write the flat arrays + geometry to npz (device-state snapshot)."""
    meta = np.array(
        [cluster.M, cluster.P, cluster.S, cluster.J, cluster.C,
         cluster.unsched_cost, cluster.ec_cost, cluster.task_cap],
        dtype=np.int64,
    )
    arrays = {name: getattr(cluster, name) for name in _BULK_ARRAYS}
    np.savez_compressed(path, __meta__=meta, **arrays)


def load_bulk_checkpoint(
    path: str, backend, machine_cost_fn=None, class_cost_fn=None
) -> "BulkCluster":
    """Rebuild a BulkCluster around checkpointed arrays. Cost callbacks
    are code, not data — pass the same machine_cost_fn/class_cost_fn the
    saved cluster used or its per-round cost refresh stays frozen."""
    from ..scheduler.bulk import BulkCluster

    data = np.load(path)
    M, P, S, J, C, unsched_cost, ec_cost, task_cap = data["__meta__"]
    cluster = BulkCluster(
        num_machines=int(M),
        pus_per_machine=int(P),
        slots_per_pu=int(S),
        num_jobs=int(J),
        backend=backend,
        unsched_cost=int(unsched_cost),
        ec_cost=int(ec_cost),
        machine_cost_fn=machine_cost_fn,
        class_cost_fn=class_cost_fn,
        num_task_classes=int(C),
        task_capacity=int(task_cap),
    )
    for name in _BULK_ARRAYS:
        getattr(cluster, name)[...] = data[name]
    # Rebuild the per-job free-row pools from task_live (single pass,
    # descending rows to match the constructor's pop order).
    cluster._job_free = [[] for _ in range(cluster.J)]
    for r in range(cluster.task_cap - 1, -1, -1):
        if not cluster.task_live[r]:
            cluster._job_free[r % cluster.J].append(r)
    return cluster


# ---------------------------------------------------------------------------
# DeviceBulkCluster (device-path) checkpoints
# ---------------------------------------------------------------------------

#: DeviceClusterState fields, in NamedTuple order
_DEVICE_STATE = (
    "live", "cls", "job", "pu", "pu_running", "machine_enabled", "grp",
)
#: GroupSpec fields (group mode only), prefixed g_ in the npz
_DEVICE_GROUPS = ("cls", "job", "e", "u", "pref_w")


def save_device_checkpoint(cluster, path: str) -> None:
    """Snapshot a DeviceBulkCluster: geometry + solver knobs + the full
    DeviceClusterState (placements, occupancy, membership, groups) and,
    in group mode, the GroupSpec arrays. One bulk device-to-host copy:
    do this outside any timed region."""
    meta = {
        "version": DEVICE_CHECKPOINT_VERSION,
        "num_machines": cluster.M,
        "pus_per_machine": cluster.P,
        "slots_per_pu": cluster.S,
        "num_jobs": cluster.J,
        "num_task_classes": cluster.C,
        "task_capacity": cluster.Tcap,
        "unsched_cost": cluster.unsched_cost,
        "ec_cost": cluster.ec_cost,
        "supersteps": cluster.supersteps,
        "decode_width": -1 if cluster.decode_width is None else cluster.decode_width,
        "alpha": cluster.alpha,
        "preemption": int(cluster.preemption),
        "continuation_discount": cluster.continuation_discount,
        "preempt_every": cluster.preempt_every,
        "preempt_drift": cluster.preempt_drift,
        "preempt_global_every": cluster.preempt_global_every,
        "preempt_scope_tau": cluster.preempt_scope_tau,
        "preempt_scoped_width": cluster.preempt_scoped_width,
        "preempt_incr_budget": cluster.preempt_incr_budget,
        "track_realized_cost": int(cluster.track_realized_cost),
        "num_groups": cluster.G if cluster.grouped else 0,
        # the full compaction ladder (a JSON list; an int in older saves)
        "active_groups_cap": list(cluster.active_groups_caps),
        "two_stage_eps0": cluster.two_stage_eps0,
        "refine_waves": cluster.refine_waves,
        "per_job": int(cluster.per_job),
    }
    arrays = {
        f"s_{name}": v for name, v in cluster.fetch_state().items()
    }
    if cluster.hybrid_preempt:
        # the stability-aware carry: census at the last full re-solve
        # and rounds since — restoring it resumes the exact cadence
        # instead of conservatively re-firing a full round
        arrays["hyb_census"] = cluster._hyb_census.cpu().numpy()
        meta["hyb_k"] = int(cluster._hyb_k)
        meta["hyb_kg"] = int(cluster._hyb_kg)
    if cluster.grouped:
        got = {k: _host(v) for k, v in cluster.groups._asdict().items()}
        arrays.update({f"g_{name}": got[name] for name in _DEVICE_GROUPS})
    if cluster.per_job:
        arrays["job_unsched_cost"] = _host(cluster.job_unsched_cost)
    # meta rides as JSON, not a single int64 array: a future float knob
    # (fractional discount, alpha) must keep its type on round-trip
    # instead of truncating silently
    np.savez_compressed(
        path,
        __kind__=np.array("device_bulk"),
        __meta_json__=np.array(json.dumps(meta)),
        **arrays,
    )


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def load_device_checkpoint(path: str, class_cost_fn=None, device="cuda"):
    """Rebuild a DeviceBulkCluster on `device` from a device checkpoint
    (saved by either package). The cost callback is code, not data —
    pass the same class_cost_fn the saved cluster used."""
    from ..scheduler.device_bulk import DeviceBulkCluster, DeviceClusterState

    data = np.load(path)
    if "__kind__" not in data or str(data["__kind__"]) != "device_bulk":
        raise ValueError(
            f"{path} is not a device_bulk checkpoint (wrong kind or a "
            "bulk/npz checkpoint — use load_bulk_checkpoint for those)"
        )
    if "__meta_json__" in data:
        meta = json.loads(str(data["__meta_json__"]))
    else:  # version 1: all-int meta in a single int64 array
        meta = {
            str(k): int(v)
            for k, v in zip(data["__meta_keys__"], data["__meta__"])
        }
    if meta["version"] not in (1, DEVICE_CHECKPOINT_VERSION):
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    cluster = DeviceBulkCluster(
        num_machines=meta["num_machines"],
        pus_per_machine=meta["pus_per_machine"],
        slots_per_pu=meta["slots_per_pu"],
        num_jobs=meta["num_jobs"],
        num_task_classes=meta["num_task_classes"],
        task_capacity=meta["task_capacity"],
        unsched_cost=meta["unsched_cost"],
        ec_cost=meta["ec_cost"],
        class_cost_fn=class_cost_fn,
        supersteps=meta["supersteps"],
        decode_width=None if meta["decode_width"] < 0 else meta["decode_width"],
        alpha=meta["alpha"],
        job_unsched_cost=(
            data["job_unsched_cost"] if meta["per_job"] else None
        ),
        preemption=bool(meta["preemption"]),
        continuation_discount=meta["continuation_discount"],
        preempt_every=meta.get("preempt_every", 1),
        preempt_drift=meta.get("preempt_drift", 0),
        preempt_global_every=meta.get("preempt_global_every", 0),
        preempt_scope_tau=meta.get("preempt_scope_tau", 1),
        # explicit None test: a saved width of 0 is a legal (if
        # degenerate) configuration and must round-trip as 0, not None
        preempt_scoped_width=(
            None
            if meta.get("preempt_scoped_width") is None
            or meta["preempt_scoped_width"] < 0
            else meta["preempt_scoped_width"]
        ),
        preempt_incr_budget=meta.get("preempt_incr_budget"),
        track_realized_cost=bool(meta.get("track_realized_cost", 0)),
        num_groups=meta["num_groups"],
        active_groups_cap=meta["active_groups_cap"],
        refine_waves=meta["refine_waves"],
        two_stage_eps0=meta.get("two_stage_eps0", "one"),
        device=device,
    )
    cluster.state = DeviceClusterState(
        **{name: torch.tensor(data[f"s_{name}"], device=cluster.device)
           for name in _DEVICE_STATE}
    )
    if cluster.grouped:
        cluster.set_groups(
            **{name: data[f"g_{name}"] for name in _DEVICE_GROUPS}
        )
    if cluster.hybrid_preempt and "hyb_census" in data:
        cluster._hyb_census = torch.tensor(data["hyb_census"], device=cluster.device)
        cluster._hyb_k = int(meta.get("hyb_k", cluster.preempt_every - 1))
        cluster._hyb_kg = int(
            meta.get("hyb_kg", max(cluster.preempt_global_every - 1, 0)))
    return cluster


# ---------------------------------------------------------------------------
# Warm-restore manifest (journal WAL + device-state manifest)
# ---------------------------------------------------------------------------
#
# The event-replay checkpoint above rebuilds only HOST scheduler state:
# a kill-and-restore lands back on the cold full_build path (fresh node
# ids, a rebuilt plan, full problem+plan upload, cold solver) and
# forfeits the delta-sized warm band. The warm manifest closes that
# gap: it snapshots the scheduler CORE (graph manager, flow graph,
# journal state, cost model, maps — one pickle, so shared descriptor
# identity survives), the DeviceGraphState + SlotPlanState geometry
# (slot table, regions, high-water marks, tail pool), and the solver's
# carried warm flow/potentials/endpoints. load_warm_manifest replays
# the records into a rebuilt scheduler whose device mirror is primed
# OUTSIDE any round, so the first post-restore round ships only that
# round's delta (plan_sync `delta`, upload `delta`) and the first
# solve is already warm — bit-identical to the never-killed process.
#
# The manifest rides the WAL record framing (runtime/integrity.py):
# seq-numbered, CRC'd records, so dropped/duplicated records and torn
# writes are detected as DISTINCT corruption kinds and the caller can
# contain them by falling back to the cold event replay.

#: scheduler attributes excluded from the core pickle (rebuilt fresh:
#: the solver holds the backend/ladder and live device buffers)
_SCHED_CORE_EXCLUDE = ("solver", "_round_in_flight")


def find_jax_solver(backend):
    """The CsrSolver (the JAX package's JaxSolver) whose warm state a
    manifest carries, if the configured rung is one (a DegradingSolver
    is unwrapped to its primary)."""
    from ..solver.csr_solver import CsrSolver
    from .degrade import DegradingSolver

    if isinstance(backend, DegradingSolver):
        backend = backend.primary
    return backend if isinstance(backend, CsrSolver) else None


def save_warm_manifest(scheduler, path: str, meta: Optional[dict] = None) -> None:
    """Write the warm-restore manifest for a FlowScheduler (see the
    section comment). Call at a round boundary with no round in flight
    and pending bindings flushed — SchedulerService.save_checkpoint
    guarantees both."""
    from .integrity import write_records

    sol = scheduler.solver
    core = {
        k: v for k, v in scheduler.__dict__.items() if k not in _SCHED_CORE_EXCLUDE
    }
    warm = None
    csr = find_jax_solver(sol.backend)
    if csr is not None:
        warm = csr.export_warm_state()
    payload = {
        "scheduler": core,
        "device_state": sol.state,
        "started": sol._started,
        "incremental": sol.incremental,
    }
    records = [
        ("meta", json.dumps(
            {"version": WARM_MANIFEST_VERSION, **(meta or {})}
        ).encode()),
        ("core", pickle.dumps(payload)),
        ("warm", pickle.dumps(warm)),
    ]
    write_records(path, records)


def load_warm_manifest(
    path: str,
    backend=None,
    device_resident: bool = False,
) -> Tuple:
    """Rebuild a FlowScheduler (+ maps) from a warm manifest and prime
    its device mirror. Returns ((scheduler, resource_map, job_map,
    task_map), meta). Raises `integrity.WALCorrupted` on a damaged
    stream and CheckpointVersionError on a version mismatch — callers
    contain both by falling back to restore_scheduler's cold replay."""
    from ..graph.device_export import _STATE_UIDS, DeviceResidentState
    from ..scheduler.flow_scheduler import FlowScheduler
    from ..solver.cpu_ref import ReferenceSolver
    from ..solver.placement import PlacementSolver
    from .integrity import read_records

    recs = dict(read_records(path))
    if not {"meta", "core", "warm"} <= set(recs):
        missing = {"meta", "core", "warm"} - set(recs)
        raise CheckpointDamaged(
            f"warm manifest {path} is missing record(s) {sorted(missing)}"
        )
    meta = json.loads(recs["meta"])
    if meta.get("version") != WARM_MANIFEST_VERSION:
        raise CheckpointVersionError(
            f"unsupported warm manifest version {meta.get('version')} "
            f"(this build writes {WARM_MANIFEST_VERSION}); re-checkpoint "
            "from a matching build or restore cold from the .sched replay"
        )
    payload = pickle.loads(recs["core"])
    warm = pickle.loads(recs["warm"])

    scheduler = FlowScheduler.__new__(FlowScheduler)
    scheduler.__dict__.update(payload["scheduler"])
    scheduler._round_in_flight = None
    st = payload["device_state"]
    # the uid feeds plan_key identity; a fresh process must never let a
    # LATER DeviceGraphState collide with the restored one's key
    old_uid = st._uid
    st._uid = next(_STATE_UIDS)
    # the pickled problem cache carries a plan_key built on the old
    # uid; drop it so the next materialize re-keys on the new one
    st._cache = None
    st._cache_nodes_ok = False
    st._cache_arcs_ok = False
    sol = PlacementSolver(
        scheduler.gm,
        backend if backend is not None else ReferenceSolver(),
        device_resident=device_resident,
    )
    sol.state = st
    sol.resident = (DeviceResidentState(st, sol.resident.device)
                    if device_resident else None)
    sol._started = payload["started"]
    sol.incremental = payload["incremental"]
    scheduler.solver = sol
    if warm is not None:
        csr = find_jax_solver(sol.backend)
        if csr is not None:
            key = warm.get("key_solved")
            if key is not None and len(key) and key[0] == old_uid:
                key = (st._uid,) + tuple(key[1:])
            csr.import_warm_state(warm, key_solved=key, resident=device_resident)
    if sol.resident is not None:
        # prime the mirror NOW (full upload + plan tensor ship happen
        # at restore time, outside any round), so the first
        # post-restore round's refresh is delta-sized
        sol.resident.refresh()
    return (
        (scheduler, scheduler.resource_map, scheduler.job_map, scheduler.task_map),
        meta,
    )
