"""The JAX package's values for chip_smoke.py's churn phase and ELL line.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_churn_reference.py [tasks machines rounds]

Runs bench.py's `churn` config (bench.py:1760-1778, defaults 10,000
tasks, 1,000 machines, 6 warm-up + 24 measured rounds) on the CPU
through the JAX package, by a twin written line by line from
`_churn_pipeline_bench`'s device-resident arm (bench.py:594-960;
bench.py asserts its `full_rebuild` and `delta_scatter` arms equal to
it every round): FlowScheduler + PlacementSolver(device_resident) +
JaxSolver(restart_budget=64), one job filling 1,000 x 1 x 4 x 4 slots,
then per round 1% of the bound tasks completed (default_rng(123)) and as
many added. Per round: supersteps, warm scope, the placements' sha256
(ksched_tpu_torch.drivers.churn.placement_sha256's formula), the plan
sync kind and the bytes shipped to the device (`last_upload_bytes`),
plus the fill's supersteps. Then the same scenario through the JAX
package's EllSolver on the device-resident export, the fill and 3
rounds: supersteps and sha256.

With soltel on (the default; KSCHED_SOLTEL=0 turns it off, and the
flows do not depend on it) each round also records the sha256 of the
CSR solve's soltel ring (`telemetry_sha256`, ksched_tpu_torch.drivers.
churn.telemetry_sha256's formula), and the run the arm's own registry's
`warm_price_war` events and host→device bytes by kind (the device
profiler's `ksched_h2d_bytes_total`).

Prints one JSON object, chip_smoke.py's REF_CHURN, with its
`cpu_seconds` (46.4 at the defaults, about 30 s of wall).
"""

import hashlib
import json
import sys
import time
from contextlib import contextmanager

import numpy as np


def placement_sha256(sched, tmap) -> str:
    rows = sorted((tmap.find(t).name, int(rid))
                  for t, rid in sched.task_bindings.items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def telemetry_sha256(tel):
    if tel is None:
        return None
    return hashlib.sha256(json.dumps(tel.to_dict(), sort_keys=True).encode()).hexdigest()


class JaxChurnArm:
    """bench.py's `_Arm` for the device-resident export (or, with
    resident=False, the delta-scatter one), with `backend` in place of
    its JaxSolver when given."""

    def __init__(self, tasks, machines, churn=0.01, restart_budget=64,
                 backend=None, resident=True):
        from ksched_tpu.drivers import add_job, build_cluster
        from ksched_tpu.graph.device_export import DeviceResidentState
        from ksched_tpu.obs import DeviceProfiler, Registry
        from ksched_tpu.solver.jax_solver import JaxSolver
        from ksched_tpu.utils import seed_rng
        from ksched_tpu.utils.ids import rng as global_rng

        self.k = max(1, int(tasks * churn))
        self.registry = Registry()
        self.profiler = DeviceProfiler(registry=self.registry)
        seed_rng(7)
        self.solver = backend if backend is not None else JaxSolver(
            restart_budget=restart_budget)
        (self.sched, self.rmap, self.jmap, self.tmap, self.root) = build_cluster(
            num_machines=machines, num_cores=1, pus_per_core=4,
            max_tasks_per_pu=4, backend=self.solver,
        )
        if resident:
            self.sched.solver.device_resident = True
            self.sched.solver.resident = DeviceResidentState(self.sched.solver.state)
        self.job_id = add_job(self.sched, self.jmap, self.tmap, num_tasks=tasks)
        with self.observed():
            self.sched.schedule_all_jobs()
        self.fill_supersteps = int(self.solver.last_supersteps)
        self.rng = np.random.default_rng(123)
        self._global_rng = global_rng
        self._rng_state = global_rng().getstate()

    @contextmanager
    def observed(self):
        """This arm's registry and device profiler, for the block."""
        from ksched_tpu.obs import devprof, scoped_registry

        prev = devprof._profiler
        devprof.set_profiler(self.profiler)
        try:
            with scoped_registry(self.registry):
                yield
        finally:
            devprof.set_profiler(prev)

    def counters(self):
        reg = self.registry
        return {
            "h2d_bytes": {k: int(reg.value("ksched_h2d_bytes_total", kind=k))
                          for k in ("full_build", "delta")},
            "price_wars": int(reg.value("ksched_solver_stalls_total",
                                        kind="warm_price_war")),
        }

    def drive_round(self, r):
        from ksched_tpu.drivers.synthetic import add_task_to_job

        self._global_rng().setstate(self._rng_state)
        sched, tmap = self.sched, self.tmap
        bound = sorted(sched.task_bindings.items())
        idx = sorted(int(x) for x in self.rng.choice(len(bound), self.k, replace=False))
        for i in reversed(idx):
            sched.handle_task_completion(tmap.find(bound[i][0]))
        for _ in range(self.k):
            add_task_to_job(self.job_id, self.jmap, tmap)
        sched.add_job(self.jmap.find(self.job_id))
        self._rng_state = self._global_rng().getstate()
        with self.observed():
            sched.schedule_all_jobs()
        res = sched.solver.resident
        out = {
            "supersteps": int(self.solver.last_supersteps),
            "warm_scope": getattr(self.solver, "last_warm_scope", None),
            "sha256": placement_sha256(sched, tmap),
        }
        tel_sha = telemetry_sha256(getattr(self.solver, "last_telemetry", None))
        if tel_sha is not None:
            out["telemetry_sha256"] = tel_sha
        if res is not None:
            out["plan_kind"] = res.last_plan_kind
            out["upload_bytes"] = int(res.last_upload_bytes)
        return out


def churn_reference(tasks=10_000, machines=1_000, rounds=30, ell_rounds=3) -> dict:
    from ksched_tpu.solver.ell_solver import EllSolver

    arm = JaxChurnArm(tasks, machines)
    out = {"fill_supersteps": arm.fill_supersteps}
    per = [arm.drive_round(r) for r in range(rounds)]
    res = arm.sched.solver.resident
    res.parity_check()
    res.plan_parity_check()
    for key in per[0]:
        out[key] = [p[key] for p in per]
    plan = arm.sched.solver.state.plan
    out["plan_counters"] = [int(plan.layout_rebuilds), int(plan.region_overflows),
                            int(plan.region_relocations)]
    from ksched_tpu.obs import soltel

    if soltel.enabled():
        out.update(arm.counters())
    ell = JaxChurnArm(tasks, machines, backend=EllSolver())
    ell_per = [ell.drive_round(r) for r in range(ell_rounds)]
    out["ell"] = {
        "fill_supersteps": ell.fill_supersteps,
        "supersteps": [p["supersteps"] for p in ell_per],
        "sha256": [p["sha256"] for p in ell_per],
    }
    return out


def main(argv) -> int:
    sizes = [int(a) for a in argv if a.isdigit()]
    tasks, machines, rounds = (sizes + [10_000, 1_000, 30][len(sizes):])[:3]
    t0 = time.process_time()
    out = churn_reference(tasks, machines, rounds)
    out["cpu_seconds"] = round(time.process_time() - t0, 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
