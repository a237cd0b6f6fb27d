"""The JAX package's values for chip_smoke.py's multi-device phases.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_parallel_reference.py [sharded] [layered] [whatif]

Runs, on the CPU through the JAX package (a virtual 2-device mesh):

- ``sharded``: bench.py's `gtrace100k` scenario (`_sharded_scale_bench`,
  bench.py:1193-1530) cut to the north star's 10,000 tasks x 1,000
  machines, keep mode, 2 warm-up + 6 rounds of 1% churn with a 10x
  burst every 8th round, on 2 devices, the gate forced from the bucket
  at the end of the warm-up (the port driver's `force_gate`): both arms (`scan_csr`: AutoSolver
  over JaxSolver; `sharded`: AutoSolver with ShardedJaxSolver behind the
  forced fitting gate and the resident mirror in sharded plan mode), by
  a twin written from bench.py's `_Arm` that records what
  ksched_tpu_torch.drivers.sharded_scale records (its COMPARED fields);
- ``layered``: drivers/parallel_scenarios.py's BulkCluster (1,000
  machines, 4 class rows, 10,000 tasks) scheduled once through the JAX
  package's LayeredTransportSolver and once through its
  ShardedLayeredSolver on 2 devices (placements sha256, supersteps),
  and one tiered instance at [4, 1,024] through
  `sharded_transport_solve_tiered` (refine_waves 8);
- ``whatif``: `drain_scenarios` (K = 16) and `surge_scenarios` (K = 8)
  on that scheduled cluster: objectives, unscheduled counts, converged
  flags and the sha256 of y.

Prints one JSON object, chip_smoke.py's REF_PARALLEL, with the seconds
each part took.
"""

import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

from ksched_tpu_torch.drivers.parallel_scenarios import (  # noqa: E402
    LAYERED,
    TIERED,
    WHATIF,
    layered_cluster,
    round_record,
    tiered_instance,
    whatif_inputs,
)
from ksched_tpu_torch.drivers.sharded_scale import COMPARED  # noqa: E402

#: the smoke's cut of gtrace100k
SHARDED = dict(tasks=10_000, machines=1_000, rounds=6, warmup=2, churn=0.01,
               burst_every=8, burst_factor=10, restart_budget=64, devices=2)


def _sha(a):
    if a is None:
        return None
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


def _mesh(devices):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:devices]), ("x",))


def placement_sha256(sched, tmap) -> str:
    rows = sorted((tmap.find(t).name, int(rid))
                  for t, rid in sched.task_bindings.items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def telemetry_sha256(tel):
    if tel is None:
        return None
    return hashlib.sha256(json.dumps(tel.to_dict(), sort_keys=True).encode()).hexdigest()


class JaxScaleArm:
    """bench.py's `_Arm` of `_sharded_scale_bench`, recording the port
    driver's round record."""

    def __init__(self, label, mesh, tasks, machines, churn, restart_budget):
        from ksched_tpu.drivers import add_job, build_cluster
        from ksched_tpu.graph.device_export import DeviceResidentState
        from ksched_tpu.obs import DeviceProfiler, Registry
        from ksched_tpu.parallel.sharded_solver import ShardedJaxSolver
        from ksched_tpu.solver.graph_collapse import AutoSolver
        from ksched_tpu.solver.jax_solver import JaxSolver
        from ksched_tpu.utils import seed_rng
        from ksched_tpu.utils.ids import rng as global_rng

        devices = int(mesh.devices.size)
        self.label = label
        self.k_base = max(1, int(tasks * churn))
        self.registry = Registry()
        self.profiler = DeviceProfiler(registry=self.registry)
        seed_rng(7)
        csr = JaxSolver(slot_stable=True, restart_budget=restart_budget)
        kw = {}
        self.sharded_backend = None
        if label == "sharded":
            self.sharded_backend = ShardedJaxSolver(mesh, restart_budget=restart_budget)
            kw = dict(sharded=self.sharded_backend, hbm_budget_bytes=0)
        self.auto = AutoSolver(csr, **kw)
        (self.sched, _rmap, self.jmap, self.tmap, _root) = build_cluster(
            num_machines=machines, num_cores=1, pus_per_core=4,
            max_tasks_per_pu=4, backend=self.auto, preemption=True,
        )
        self.res = DeviceResidentState(self.sched.solver.state)
        if label == "sharded":
            self.res.enable_sharded_plan(mesh, "x")
        else:
            self.sched.solver.state.plan.enable_sharding(devices)
        self.sched.solver.device_resident = True
        self.sched.solver.resident = self.res
        self.job_id = add_job(self.sched, self.jmap, self.tmap, num_tasks=tasks)
        t0 = time.perf_counter()
        with self.observed():
            self.sched.schedule_all_jobs()
        self.fill_s = time.perf_counter() - t0
        self.budget = None
        self.devices = devices
        self.rng = np.random.default_rng(123)
        self._global_rng = global_rng
        self._rng_state = global_rng().getstate()

    def force_gate(self):
        """ksched_tpu_torch.drivers.sharded_scale.ScaleArm.force_gate:
        the budget from the bucket at the end of the warm-up."""
        from ksched_tpu.parallel.sharded_solver import (
            csr_working_set_bytes,
            sharded_shard_bytes,
        )

        if self.label != "sharded":
            return
        st = self.sched.solver.state
        self.budget = (sharded_shard_bytes(st.n_cap, st.m_cap, self.devices)
                       + csr_working_set_bytes(st.n_cap, st.m_cap)) // 2
        self.auto.hbm_budget_bytes = self.budget

    def observed(self):
        from contextlib import contextmanager

        from ksched_tpu.obs import devprof, scoped_registry

        @contextmanager
        def scope():
            prev = devprof._profiler
            devprof.set_profiler(self.profiler)
            try:
                with scoped_registry(self.registry):
                    yield
            finally:
                devprof.set_profiler(prev)

        return scope()

    def h2d(self, kind):
        return int(self.registry.value("ksched_h2d_bytes_total", kind=kind))

    def drive_round(self, r, kind, k):
        from ksched_tpu.drivers.synthetic import add_task_to_job

        self._global_rng().setstate(self._rng_state)
        sched, tmap = self.sched, self.tmap
        bound = sorted(sched.task_bindings.items())
        k = min(k, len(bound))
        idx = sorted(int(x) for x in self.rng.choice(len(bound), k, replace=False))
        for i in reversed(idx):
            sched.handle_task_completion(tmap.find(bound[i][0]))
        for _ in range(k):
            add_task_to_job(self.job_id, self.jmap, tmap)
        sched.add_job(self.jmap.find(self.job_id))
        self._rng_state = self._global_rng().getstate()
        gen0 = sched.solver.state.generation
        with self.observed():
            sched.schedule_all_jobs()
        auto = self.auto
        solver = auto.sharded if auto.last_path == "sharded" else auto.csr
        plan_kind = self.res.last_plan_kind
        if plan_kind == "rebuild" and sched.solver.state.generation != gen0:
            plan_kind = "rebuild_pow2_growth"
        result = sched.solver.last_result
        p = getattr(solver, "_prev_p", None)
        tel = auto.last_telemetry
        return {
            "round": r,
            "kind": kind,
            "path": auto.last_path,
            "supersteps": int(auto.last_supersteps),
            "converged": None if tel is None else bool(tel.converged),
            "sha256": placement_sha256(sched, tmap),
            "flow_sha256": _sha(np.asarray(result.flow, np.int64)) if result else None,
            "p_sha256": _sha(None if p is None else np.asarray(p, np.int32)),
            "warm_scope": getattr(solver, "last_warm_scope", None),
            "plan_kind": plan_kind,
            "h2d_full": self.h2d("full_build"),
            "h2d_delta": self.h2d("delta"),
            "telemetry_sha256": telemetry_sha256(tel),
        }


def sharded_reference(tasks, machines, rounds, warmup, churn, burst_every,
                      burst_factor, restart_budget, devices):
    mesh = _mesh(devices)
    arms = [JaxScaleArm(label, mesh, tasks, machines, churn, restart_budget)
            for label in ("scan_csr", "sharded")]
    k_base = arms[0].k_base
    out = {a.label: [] for a in arms}
    for r in range(warmup + rounds):
        if r == warmup:
            for a in arms:
                a.force_gate()
        kind = ("burst" if burst_every and r % burst_every == burst_every - 1
                else "churn")
        k = k_base * (burst_factor if kind == "burst" else 1)
        recs = [a.drive_round(r, kind, k) for a in arms]
        assert recs[0]["sha256"] == recs[1]["sha256"], f"round {r}"
        for a, rec in zip(arms, recs):
            out[a.label].append({f: rec[f] for f in COMPARED})
    sh = arms[1]
    st = sh.sched.solver.state
    return {
        "args": dict(tasks=tasks, machines=machines, rounds=rounds, warmup=warmup,
                     churn=churn, burst_every=burst_every,
                     burst_factor=burst_factor, restart_budget=restart_budget,
                     devices=devices),
        "arms": out,
        "budget": sh.budget,
        "bucket": {"n_cap": st.n_cap, "m_cap": st.m_cap,
                   "entry_cap": st.plan.entry_cap,
                   "block_extent": st.plan.block_extent},
    }


def layered_reference(devices=2):
    from ksched_tpu.parallel.sharded_transport import (
        ShardedLayeredSolver,
        sharded_transport_solve_tiered,
    )
    from ksched_tpu.scheduler.bulk import BulkCluster
    from ksched_tpu.solver.layered import LayeredTransportSolver

    mesh = _mesh(devices)
    out = {}
    for label, backend in (("single", LayeredTransportSolver()),
                           ("sharded", ShardedLayeredSolver(mesh))):
        cluster = layered_cluster(BulkCluster, backend, **LAYERED)
        res = cluster.round()
        out[label] = dict(round_record(cluster, res),
                          supersteps=int(backend.last_supersteps))
    assert out["single"] == out["sharded"], out
    wLo, wHi, R, supply, cap, eps0 = tiered_instance(**TIERED)
    y, steps, conv = sharded_transport_solve_tiered(
        mesh, wLo, wHi, R, supply, cap, np.int32(eps0),
        refine_waves=TIERED["refine_waves"])
    out["tiered"] = {"y_sha256": _sha(np.asarray(y, np.int32)),
                     "steps": int(steps), "converged": bool(conv)}
    return out


def whatif_reference():
    from ksched_tpu.parallel.whatif import drain_scenarios, surge_scenarios
    from ksched_tpu.scheduler.bulk import BulkCluster
    from ksched_tpu.solver.layered import LayeredTransportSolver

    cluster = layered_cluster(BulkCluster, LayeredTransportSolver(), **LAYERED)
    cluster.round()
    machines, surge = whatif_inputs(cluster, **WHATIF)
    out = {}
    for label, res in (("drain", drain_scenarios(cluster, machines)),
                       ("surge", surge_scenarios(cluster, surge))):
        out[label] = {
            "objective": [int(x) for x in res.objective],
            "num_unsched": [int(x) for x in res.num_unsched],
            "converged": [bool(x) for x in res.converged],
            "y_sha256": _sha(np.asarray(res.y, np.int64)),
        }
    return out


def main(argv):
    parts = argv or ["sharded", "layered", "whatif"]
    out = {}
    for part in parts:
        t0 = time.process_time()
        if part == "sharded":
            out["sharded"] = sharded_reference(**SHARDED)
        elif part == "layered":
            out["sharded_layered"] = layered_reference()
        elif part == "whatif":
            out["whatif"] = whatif_reference()
        else:
            raise SystemExit(f"unknown part {part!r}")
        out.setdefault("cpu_seconds", {})[part] = round(time.process_time() - t0, 1)
    print(json.dumps(out, sort_keys=True))


if __name__ == "__main__":
    main(sys.argv[1:])
