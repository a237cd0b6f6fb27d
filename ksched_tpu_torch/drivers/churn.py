"""bench.py's `churn` config: steady 1% churn on the event path, three
export arms held placement-identical round by round.

Port of the parity arms of bench.py `_churn_pipeline_bench`
(bench.py:594-960): `FlowScheduler` + `PlacementSolver` + the scan-CSR
`CsrSolver` (the JAX package's `JaxSolver`, slot-stable plan, refitted
prices, restart budget 64) on a cluster of 1,000 machines x 1 core x 4
PUs x 4 slots that one job of 10,000 tasks fills; then every round
completes 1% of the bound tasks (k = 100, drawn by
``default_rng(123)``), adds k new tasks to the job and schedules. The
arms differ only in how the folded problem reaches the solver:

- ``full_rebuild``: the problem() cache is bypassed, so every round
  re-copies and refolds all host arrays, and the solver uploads them;
- ``delta_scatter``: the journal scatters into the host arrays and the
  cache rebuilds only the dirty groups; the solver uploads them;
- ``device_resident``: persistent tensors on the card
  (graph/device_export.DeviceResidentState); only the packed problem
  and plan delta records cross to the card.

Task and job ids come from the seeded global id RNG (utils/ids.py), so
the arms run round-robin and each swaps its own stream state in around
its round, as bench.py does. Each arm also swaps in its own metrics
registry and device profiler (obs/), so its counters (host→device bytes
by kind, stall events) are its own. bench.py's `reference` and `r11_policy`
arms (the historical baselines) are not ported.
"""

from __future__ import annotations

import hashlib
import json
import time
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np

#: bench.py's arguments for the `churn` config
CHURN = dict(tasks=10_000, machines=1_000, churn=0.01, restart_budget=64,
             warmup=6, rounds=24)
#: the parity arms, in bench.py's order
ARMS = ("full_rebuild", "delta_scatter", "device_resident")


def placement_sha256(sched, tmap) -> str:
    """sha256 of the sorted (task name, resource id) placements."""
    rows = sorted((tmap.find(t).name, int(rid))
                  for t, rid in sched.task_bindings.items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def telemetry_sha256(tel) -> Optional[str]:
    """sha256 of a decoded soltel ring (obs/soltel.SolveTelemetry, all
    its fields and rows), None without one."""
    if tel is None:
        return None
    return hashlib.sha256(json.dumps(tel.to_dict(), sort_keys=True).encode()).hexdigest()


class ChurnArm:
    """One arm of the churn config: its cluster filled by one job of
    `tasks` tasks (the fill round runs here), then `drive_round(r)` per
    round. `backend` defaults to bench.py's CsrSolver on `device`."""

    def __init__(self, label: str, tasks: int = CHURN["tasks"],
                 machines: int = CHURN["machines"], churn: float = CHURN["churn"],
                 device="cuda", backend=None):
        from ..solver.csr_solver import CsrSolver
        from ..utils import seed_rng
        from ..utils.ids import rng as global_rng
        from .synthetic import add_job, build_cluster

        if label not in ARMS:
            raise ValueError(f"unknown churn arm {label!r}; want one of {ARMS}")
        from ..obs import DeviceProfiler, Registry

        self.label = label
        self.k = max(1, int(tasks * churn))
        self.registry = Registry()
        self.profiler = DeviceProfiler(registry=self.registry)
        seed_rng(7)
        self.solver = (backend if backend is not None
                       else CsrSolver(restart_budget=CHURN["restart_budget"], device=device))
        (self.sched, _rmap, self.jmap, self.tmap, _root) = build_cluster(
            num_machines=machines, num_cores=1, pus_per_core=4,
            max_tasks_per_pu=4, backend=self.solver,
            device_resident=label == "device_resident",
        )
        self.job_id = add_job(self.sched, self.jmap, self.tmap, num_tasks=tasks)
        t0 = time.perf_counter()
        with self.observed():
            self.sched.schedule_all_jobs()
        self.fill_s = time.perf_counter() - t0
        self.fill_supersteps = self.solver.last_supersteps
        self.rng = np.random.default_rng(123)
        # each arm's own continuation of the seeded id stream
        self._global_rng = global_rng
        self._rng_state = global_rng().getstate()

    @contextmanager
    def observed(self):
        """This arm's registry and device profiler, for the block."""
        from ..obs import devprof, scoped_registry

        prev = devprof._profiler
        devprof.set_profiler(self.profiler)
        try:
            with scoped_registry(self.registry):
                yield
        finally:
            devprof.set_profiler(prev)

    def counters(self) -> Dict:
        """The arm's host→device bytes by kind and its warm price wars,
        from its own registry."""
        reg = self.registry
        return {
            "h2d_bytes": {k: int(reg.value("ksched_h2d_bytes_total", kind=k))
                          for k in ("full_build", "delta")},
            "price_wars": int(reg.value("ksched_solver_stalls_total",
                                        kind="warm_price_war")),
        }

    def drive_round(self, r: int) -> Dict:
        """Complete k bound tasks, add k, schedule; the round's record:
        wall ms (host clock around `schedule_all_jobs`), supersteps,
        warm scope, the placements' sha256, the solver's host reads, the
        bytes it copied to the card (`solver_upload_bytes`) and, on the
        resident arm, the mirror's plan sync kind and the bytes it
        shipped (`upload_bytes`), and the sha256 of the solve's soltel
        ring (`telemetry_sha256`, None with telemetry off)."""
        from .synthetic import add_task_to_job

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
        if self.label == "full_rebuild":
            # bypass the problem() cache: re-copy and refold everything
            st = sched.solver.state
            st._cache_nodes_ok = st._cache_arcs_ok = False
        t0 = time.perf_counter()
        with self.observed():
            sched.schedule_all_jobs()
        wall_ms = (time.perf_counter() - t0) * 1e3
        res = sched.solver.resident
        return {
            "round": r,
            "wall_ms": wall_ms,
            "supersteps": int(self.solver.last_supersteps),
            "warm_scope": getattr(self.solver, "last_warm_scope", None),
            "sha256": placement_sha256(sched, tmap),
            "host_reads": int(getattr(self.solver, "last_host_reads", 0)),
            "plan_kind": res.last_plan_kind if res is not None else None,
            "upload_bytes": int(res.last_upload_bytes) if res is not None else None,
            "solver_upload_bytes": getattr(self.solver, "last_upload_bytes", None),
            "telemetry_sha256": telemetry_sha256(getattr(self.solver, "last_telemetry", None)),
        }


def drive_arms(arms, rounds: Optional[int] = None, on_round=None) -> Dict:
    """Drive built arms `rounds` rounds (bench.py's 6 warm-up + 24
    measured by default) round-robin; raises AssertionError when the
    arms' placements differ in a round, or a resident arm's mirror or
    plan differs from the host. `on_round(arm, record)` is called after
    each arm's round. Returns {label: [round records]}."""
    if rounds is None:
        rounds = CHURN["warmup"] + CHURN["rounds"]
    out = {a.label: [] for a in arms}
    for r in range(rounds):
        shas = set()
        for a in arms:
            rec = a.drive_round(r)
            out[a.label].append(rec)
            shas.add(rec["sha256"])
            res = a.sched.solver.resident
            if res is not None:
                res.parity_check()
                res.plan_parity_check()
            if on_round is not None:
                on_round(a, rec)
        if len(shas) != 1:
            raise AssertionError(f"churn round {r}: the arms' placements differ")
    return out


def run_churn(rounds: Optional[int] = None, on_round=None, **kw) -> Dict:
    """Build the three arms (ChurnArm's keyword arguments in `kw`) and
    drive them (`drive_arms`); the result also holds the arms under
    "objects"."""
    objs = [ChurnArm(label, **kw) for label in ARMS]
    out = drive_arms(objs, rounds, on_round)
    out["objects"] = {a.label: a for a in objs}
    return out
