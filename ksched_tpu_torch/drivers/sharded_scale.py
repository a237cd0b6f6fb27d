"""bench.py's `gtrace100k`: the sharded rung's scale run on the event
path, two paired arms held placement-identical round by round.

Port of bench.py `_sharded_scale_bench` (bench.py:1193-1530, config at
:1781). A cluster of `machines` machines x 1 core x 4 PUs x 4 slots
with preemption on (keep mode: after the fill every round's graph
carries per-task leaf arcs and is genuinely non-collapsible, the case
the fitting gate governs) is filled by one job of `tasks` tasks; then
every round completes a share of the bound tasks (drawn by
`default_rng(123)`), adds as many new ones and schedules. Every
`burst_every`-th round churns `burst_factor` times the base rate. Both
arms drive the same seeded scenario through AutoSolver, dispatch
included:

- ``scan_csr``: AutoSolver with no sharded rung; every general-graph
  round solves on the single-device slot-stable CsrSolver;
- ``sharded``: AutoSolver with the sharded rung over `mesh` and the
  working-set budget set BETWEEN the per-shard and single-device live
  sets of the bucket the measured rounds run in, so the gate escalates
  every measured round; the device-resident mirror runs in sharded
  plan mode (each rank its own [Es] block, records routed to their
  owner ranks).

bench.py sets that budget from the bucket right after the fill. Here it
is set from the bucket at the end of the warm-up rounds (`force_gate`),
before the first measured round: at gtrace100k's size the two are the
same bucket, but at a cut size the first churn round grows the arc
bucket (keep mode adds per-task leaf arcs), and a budget from the
fill's bucket then sits below the grown per-shard set, so the gate
would never escalate. Until then the budget is 0: the sharded arm's
warm-up rounds solve on the CSR rung.

Both arms use the sharded-block plan layout (one entry order, one
rebuild schedule), so their placements are bit-identical by
construction, and `run_sharded_scale` asserts it every round.

SPMD: every rank of `mesh` runs this whole driver with the same seeds
(both arms), so every rank holds the same host state and issues the
same collectives. A round's record carries what the JAX package's run
at the same arguments can be held to: supersteps, the AutoSolver path,
the sha256 of the placements, of the solve's flow and of the solver's
carried potentials, the plan sync kind, the arm's host-to-device bytes
by kind (global counts) and the sha256 of the solve's soltel ring.
"""

from __future__ import annotations

import hashlib
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

#: bench.py's arguments for `gtrace100k`
GTRACE100K = dict(tasks=100_000, machines=10_000, rounds=30, warmup=4,
                  churn=0.01, burst_every=8, burst_factor=10, devices=8,
                  restart_budget=64)
#: the paired arms, in bench.py's order
ARMS = ("scan_csr", "sharded")


def _sha(a) -> Optional[str]:
    if a is None:
        return None
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


class ScaleArm:
    """One arm: its cluster built and filled (the fill round runs
    here), then `drive_round(r)` per round. The sharded arm's budget is
    forced between the working sets of the filled bucket."""

    def __init__(self, label: str, mesh, tasks: int, machines: int,
                 churn: float, restart_budget: int, device):
        from ..obs import DeviceProfiler, Registry
        from ..parallel.sharded_solver import ShardedJaxSolver
        from ..solver.csr_solver import CsrSolver
        from ..solver.graph_collapse import AutoSolver
        from ..utils import seed_rng
        from ..utils.ids import rng as global_rng
        from .synthetic import add_job, build_cluster

        if label not in ARMS:
            raise ValueError(f"unknown arm {label!r}; want one of {ARMS}")
        self.label = label
        self.k_base = max(1, int(tasks * churn))
        self.registry = Registry()
        self.profiler = DeviceProfiler(registry=self.registry)
        seed_rng(7)
        csr = CsrSolver(restart_budget=restart_budget, device=device)
        self.sharded_backend = None
        kw = {}
        if label == "sharded":
            self.sharded_backend = ShardedJaxSolver(mesh, restart_budget=restart_budget)
            # the forcing budget is set after the fill (it needs the
            # padded bucket); 0 until then = never escalate
            kw = dict(sharded=self.sharded_backend, hbm_budget_bytes=0)
        self.auto = AutoSolver(csr, device=device, **kw)
        (self.sched, _rmap, self.jmap, self.tmap, _root) = build_cluster(
            num_machines=machines, num_cores=1, pus_per_core=4,
            max_tasks_per_pu=4, backend=self.auto, preemption=True,
            device_resident=True,
        )
        self.res = self.sched.solver.resident
        if label == "sharded":
            self.res.enable_sharded_plan(mesh)
        else:
            # the reference arm consumes the SAME sharded-block layout:
            # one entry order and one rebuild schedule across the arms
            self.sched.solver.state.plan.enable_sharding(mesh.size)
        self.job_id = add_job(self.sched, self.jmap, self.tmap, num_tasks=tasks)
        t0 = time.perf_counter()
        with self.observed():
            self.sched.schedule_all_jobs()
        self.fill_s = time.perf_counter() - t0
        self.budget = None
        self.rng = np.random.default_rng(123)
        self._global_rng = global_rng
        self._rng_state = global_rng().getstate()

    def force_gate(self) -> None:
        """The sharded arm's budget: halfway between the per-shard and
        the single-device working sets of the current bucket, so the
        single-device set no longer fits and the shard's does."""
        from ..parallel.sharded_solver import csr_working_set_bytes, sharded_shard_bytes

        if self.label != "sharded":
            return
        st = self.sched.solver.state
        self.budget = (sharded_shard_bytes(st.n_cap, st.m_cap, self.sharded_backend.num_shards)
                       + csr_working_set_bytes(st.n_cap, st.m_cap)) // 2
        self.auto.hbm_budget_bytes = self.budget

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

    def h2d(self, kind: str) -> int:
        return int(self.registry.value("ksched_h2d_bytes_total", kind=kind))

    def drive_round(self, r: int, kind: str, k: int) -> Dict:
        """Complete k bound tasks, add k, schedule; the round's record."""
        from .churn import placement_sha256, telemetry_sha256
        from .synthetic import add_task_to_job

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
        t0 = time.perf_counter()
        with self.observed():
            sched.schedule_all_jobs()
        wall_ms = (time.perf_counter() - t0) * 1e3
        auto = self.auto
        solver = auto.sharded if auto.last_path == "sharded" else auto.csr
        res = self.res
        plan_kind = res.last_plan_kind
        if plan_kind == "rebuild" and sched.solver.state.generation != gen0:
            plan_kind = "rebuild_pow2_growth"  # pow2 growth rebuilds by design
        result = sched.solver.last_result
        tel = auto.last_telemetry
        return {
            "round": r,
            "kind": kind,
            "wall_ms": wall_ms,
            "path": auto.last_path,
            "supersteps": int(auto.last_supersteps),
            "converged": None if tel is None else bool(tel.converged),
            "sha256": placement_sha256(sched, tmap),
            "flow_sha256": _sha(np.asarray(result.flow, np.int64)) if result else None,
            "p_sha256": _sha(getattr(solver, "_prev_p", None)),
            "warm_scope": getattr(solver, "last_warm_scope", None),
            "plan_kind": plan_kind,
            "h2d_full": self.h2d("full_build"),
            "h2d_delta": self.h2d("delta"),
            "telemetry_sha256": telemetry_sha256(tel),
            "plan_rank_bytes": int(res.last_plan_rank_bytes),
        }


#: the record fields two runs of this config (either package, any rank)
#: must agree on; wall time and this rank's own bytes are not among them
COMPARED = ("round", "kind", "path", "supersteps", "converged", "sha256",
            "flow_sha256", "p_sha256", "warm_scope", "plan_kind", "h2d_full",
            "h2d_delta", "telemetry_sha256")


def run_sharded_scale(mesh, tasks: int = GTRACE100K["tasks"],
                      machines: int = GTRACE100K["machines"],
                      rounds: int = GTRACE100K["rounds"],
                      warmup: int = GTRACE100K["warmup"],
                      churn: float = GTRACE100K["churn"],
                      burst_every: int = GTRACE100K["burst_every"],
                      burst_factor: int = GTRACE100K["burst_factor"],
                      restart_budget: int = GTRACE100K["restart_budget"],
                      device="cuda") -> Dict:
    """Build both arms and drive `warmup + rounds` rounds; raises
    AssertionError when the arms' placements differ in a round, when
    the sharded arm failed to escalate a measured round, or when its
    mirror disagrees with the host. Returns {"arms": {label: [records]},
    "fill_s", "budget", "bucket", "collectives"} (the mesh's collective
    counts of the sharded arm's measured rounds, by call site)."""
    arms: List[ScaleArm] = [ScaleArm(label, mesh, tasks, machines, churn,
                                     restart_budget, device) for label in ARMS]
    k_base = arms[0].k_base
    out = {a.label: [] for a in arms}
    mesh.reset_counts()
    supersteps = 0
    for r in range(warmup + rounds):
        if r == warmup:
            for a in arms:
                a.force_gate()
        kind = ("burst" if burst_every and r % burst_every == burst_every - 1
                else "churn")
        k = k_base * (burst_factor if kind == "burst" else 1)
        recs = [a.drive_round(r, kind, k) for a in arms]
        if recs[0]["sha256"] != recs[1]["sha256"]:
            raise AssertionError(f"round {r}: sharded placements diverged from "
                                 "the scan-CSR arm")
        if r == warmup - 1:
            mesh.reset_counts()
        elif r >= warmup:
            supersteps += recs[1]["supersteps"]
        for a, rec in zip(arms, recs):
            out[a.label].append(rec)
    sh, ref = arms[1], arms[0]
    measured = out["sharded"][warmup:]
    if rounds and not all(rec["path"] == "sharded" for rec in measured):
        raise AssertionError("the sharded arm did not escalate every measured round: "
                             f"{[rec['path'] for rec in measured]}")
    if any(rec["path"] == "sharded" for rec in out["scan_csr"]):
        raise AssertionError("the reference arm took the sharded rung")
    if sh.sharded_backend._plan is not None:
        raise AssertionError("the legacy build_sharded_plan ran on the slot-stable path")
    bad = [rec["round"] for rec in measured if rec["plan_kind"] == "rebuild"]
    if bad:
        raise AssertionError(f"sharded plan rebuilds outside pow2 growth in rounds {bad}")
    sh.res.parity_check()
    sh.res.plan_parity_check()
    st = sh.sched.solver.state
    return {
        "arms": out,
        "fill_s": {a.label: a.fill_s for a in arms},
        "budget": sh.budget,
        "bucket": {"n_cap": st.n_cap, "m_cap": st.m_cap,
                   "entry_cap": st.plan.entry_cap,
                   "block_extent": st.plan.block_extent},
        "collectives": mesh.by_site(),
        "measured_supersteps": supersteps,
        "objects": {"scan_csr": ref, "sharded": sh},
    }

