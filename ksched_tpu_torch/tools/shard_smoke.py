"""shard-smoke: the multi-device rung's fixed-seed churn soak.

Runs the SAME seeded churn scenario through three arms on every rank of
a torch.distributed group (parallel/launch.py starts the ranks):

1. **scan-CSR reference**: the single-device slot-stable CsrSolver
   (restart budget 64) on the device-resident mirror, over the sharded
   plan layout (one entry order and one rebuild schedule for both arms,
   so the comparison is pure single-device against sharded execution);
2. **sharded**: ShardedJaxSolver over the group, the resident mirror in
   sharded plan mode (each rank its own entry block, records routed to
   their owner ranks). Per round, placements BIT-IDENTICAL to arm 1;
   after warm-up every plan sync is delta-sized ("delta"/"clean": no
   layout rebuild outside pow2 growth and pool exhaustion, and the
   legacy build_sharded_plan cache stays empty);
3. **chaos**: the sharded rung on top of the degradation ladder
   (sharded -> jax -> cpu_ref) under seeded solver-fault injection:
   every round lands, at least one degradation fires, rounds land on
   both the sharded and the jax rung, and a second identically seeded
   run places bit-identically.

Every rank draws the same fault schedule (the injector is seeded alike
and drawn on the host), so the ranks step down together: a rank-local
step-down would leave the others waiting in the next collective (and a
collective's failure is re-raised, never stepped down from).

Usage (the Makefile's arguments, D ranks sharing the card over gloo):
  python -m ksched_tpu_torch.tools.shard_smoke --machines 6 --tasks 48 \\
      --rounds 24 --warmup 4 --devices 2 --seed 7 [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import numpy as np

#: the Makefile's shard-smoke arguments (its --devices is the virtual
#: mesh's 8; here the rank count, 2 sharing one card)
MAKEFILE = dict(machines=6, tasks=48, rounds=24, warmup=4, seed=7)


def placements_sha256(rounds) -> list:
    """Per round, the sha256 of its sorted {task name: resource id}."""
    return [hashlib.sha256(json.dumps(sorted(p.items())).encode()).hexdigest()
            for p in rounds]


def build_arm(backend, machines: int, tasks: int, *, mesh=None, plan_shards=None,
              seed: int = 7):
    """The seeded cluster of `machines` x 1 core x 4 PUs x 4 slots on
    `backend` with the problem resident on its device; sharded plan mode
    over `mesh`, or the sharded layout alone over `plan_shards` blocks;
    `tasks` tasks in one job, scheduled once."""
    from ..drivers.synthetic import add_job, build_cluster
    from ..utils import seed_rng

    seed_rng(seed)
    sched, _rmap, jmap, tmap, _root = build_cluster(
        num_machines=machines, num_cores=1, pus_per_core=4, max_tasks_per_pu=4,
        backend=backend, device_resident=True)
    res = sched.solver.resident
    if mesh is not None:
        res.enable_sharded_plan(mesh)
    elif plan_shards is not None:
        sched.solver.state.plan.enable_sharding(plan_shards)
    job_id = add_job(sched, jmap, tmap, num_tasks=tasks)
    sched.schedule_all_jobs()
    return sched, jmap, tmap, job_id, res


def drive_arm(label, backend, *, machines, tasks, rounds, warmup, seed=7, mesh=None,
              plan_shards=None, injector=None, verbose=False, log=print):
    """Run the seeded churn scenario: per round complete k = tasks // 12
    bound tasks (`default_rng(123)`), add k, schedule. Returns
    (placements per round, plan-sync kinds after warm-up, scheduler,
    mirror, landing rungs, growth-waived rebuilds)."""
    from ..drivers.synthetic import add_task_to_job

    sched, jmap, tmap, job_id, res = build_arm(
        backend, machines, tasks, mesh=mesh, plan_shards=plan_shards, seed=seed)
    rng = np.random.default_rng(123)
    k = max(1, tasks // 12)
    placements, kinds, rungs = [], {}, {}
    waived = 0
    t0 = time.perf_counter()
    for r in range(rounds):
        if injector is not None:
            injector.begin_round(r)
        bound = sorted(sched.task_bindings.items())
        idx = sorted(int(x) for x in rng.choice(len(bound), k, replace=False))
        for i in reversed(idx):
            sched.handle_task_completion(tmap.find(bound[i][0]))
        for _ in range(k):
            add_task_to_job(job_id, jmap, tmap)
        sched.add_job(jmap.find(job_id))
        gen0 = sched.solver.state.generation
        overflow0 = sched.solver.state.plan.region_overflows
        sched.schedule_all_jobs()
        placements.append({tmap.find(t).name: rid for t, rid in sched.task_bindings.items()})
        rung = getattr(backend, "last_rung_name", None)
        if rung is not None:
            rungs[rung] = rungs.get(rung, 0) + 1
        if r >= warmup:
            kind = res.last_plan_kind
            # waived: the documented rebuild triggers, pow2 bucket growth
            # (generation moved) and tail-pool exhaustion (overflows
            # moved); any other rebuild after warm-up is a regression
            if kind == "rebuild":
                grew = sched.solver.state.generation != gen0
                overflowed = sched.solver.state.plan.region_overflows != overflow0
                assert grew or overflowed, (
                    f"{label} round {r}: plan layout rebuilt outside full_build / "
                    "pow2 growth / pool exhaustion — post-warm-up rounds must be "
                    "delta-sized")
                waived += 1
            else:
                kinds[kind] = kinds.get(kind, 0) + 1
        if verbose:
            log(f"# {label} round {r}: plan={res.last_plan_kind}", file=sys.stderr)
    wall = time.perf_counter() - t0
    log(f"# {label}: {rounds} rounds in {wall:.1f}s, plan kinds {kinds}"
        + (f", {waived} growth-waived rebuild(s)" if waived else ""))
    return placements, kinds, sched, res, rungs, waived


def run_smoke(mesh, machines=MAKEFILE["machines"], tasks=MAKEFILE["tasks"],
              rounds=MAKEFILE["rounds"], warmup=MAKEFILE["warmup"], seed=MAKEFILE["seed"],
              verbose=False, log=print) -> dict:
    """The three arms on this rank of `mesh`; raises AssertionError when
    an arm breaks its check. Returns per arm what two runs (either
    package, any rank) are held to: placements' sha256 per round and
    the plan kinds after warm-up, and for the chaos arm its
    degradations, fault snapshot and landing rungs."""
    import warnings

    from ..parallel.sharded_solver import ShardedJaxSolver
    from ..runtime.chaos import ChaosPolicy, FaultInjector
    from ..runtime.degrade import build_degradation_ladder
    from ..solver.csr_solver import CsrSolver

    device = mesh.device
    common = dict(machines=machines, tasks=tasks, rounds=rounds, warmup=warmup,
                  seed=seed, verbose=verbose, log=log)
    # ---- arm 1: single-device scan-CSR reference ----
    ref_pl, ref_kinds, _, _, _, _ = drive_arm(
        "scan-csr", CsrSolver(slot_stable=True, restart_budget=64, device=device),
        plan_shards=mesh.size, **common)
    # ---- arm 2: sharded, resident sharded plan mode ----
    sharded = ShardedJaxSolver(mesh)
    sh_pl, sh_kinds, _sched, sh_res, _, _ = drive_arm(
        "sharded", sharded, mesh=mesh, **common)
    for r, (a, b) in enumerate(zip(ref_pl, sh_pl)):
        assert a == b, (f"round {r}: sharded placements diverged from the scan-CSR "
                        f"reference ({len(b)} vs {len(a)} bindings)")
    assert sharded.last_path == "slot_stable", sharded.last_path
    assert sharded._plan is None, (
        "the legacy build_sharded_plan path ran — slot-stable rounds must never "
        "argsort a ShardedPlan")
    assert sh_kinds.get("delta", 0) > 0, sh_kinds
    sh_res.parity_check()
    sh_res.plan_parity_check()
    log(f"# parity: {len(ref_pl)} rounds bit-identical; sharded plan syncs "
        f"post-warm-up: {sh_kinds}")

    # ---- arm 3: chaos containment on the sharded rung ----
    def chaos_run():
        injector = FaultInjector(ChaosPolicy(seed=seed, solver_fault_prob=0.25))
        ladder = build_degradation_ladder(ShardedJaxSolver(mesh), "sharded",
                                          injector=injector, device=device)
        assert ladder.rung_names() == ["sharded", "jax", "cpu_ref"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            pl, _, _, _, rungs, _ = drive_arm("chaos", ladder, injector=injector,
                                              **common)
        return pl, ladder.degradations_total, injector.snapshot(), rungs

    pl_a, degr_a, snap_a, rungs_a = chaos_run()
    pl_b, degr_b, snap_b, _rungs_b = chaos_run()
    assert degr_a > 0, "chaos arm drew no solver faults; raise the prob"
    # fault-free rounds land on the sharded rung, and a sharded-rung
    # fault must land on the jax rung (a dead middle rung would fall
    # through to the cpu_ref oracle unseen)
    assert rungs_a.get("sharded", 0) > 0, rungs_a
    assert rungs_a.get("jax", 0) > 0, (
        "no degraded round landed on the jax rung — the sharded -> jax "
        "containment rung is dead", rungs_a)
    assert degr_a == degr_b and snap_a == snap_b, "chaos runs drew different fault schedules"
    for r, (a, b) in enumerate(zip(pl_a, pl_b)):
        assert a == b, f"round {r}: chaos arm not deterministic"
    log(f"# chaos containment: {degr_a} degradations off the sharded rung, every "
        f"round landed, twin runs bit-identical (landing rungs: {rungs_a}; "
        f"faults: {snap_a})")
    log("shard-smoke OK")
    return {
        "scan_csr": {"placements_sha256": placements_sha256(ref_pl),
                     "kinds": dict(sorted(ref_kinds.items()))},
        "sharded": {"placements_sha256": placements_sha256(sh_pl),
                    "kinds": dict(sorted(sh_kinds.items()))},
        "chaos": {"placements_sha256": placements_sha256(pl_a), "degradations": degr_a,
                  "faults": dict(sorted(snap_a.items())),
                  "rungs": dict(sorted(rungs_a.items()))},
    }


def rank_smoke(rank, world, payload):
    """One rank of the smoke (parallel/launch.py's target): the three
    arms over the launch's group on `payload["device"]`; returns
    run_smoke's record, this rank's wall and the group's backend."""
    from ..parallel.mesh import ShardMesh

    args = dict(payload)
    mesh = ShardMesh(None, device=args.pop("device"))
    t0 = time.perf_counter()
    lines = []
    out = run_smoke(mesh, log=lambda s, **k: lines.append(s), **args)
    out["wall_s"] = time.perf_counter() - t0
    out["backend"] = mesh.backend
    out["log"] = lines
    return out


def main(argv=None, log=print) -> int:
    from ..parallel.launch import run_ranks
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.shard_smoke",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--machines", type=int, default=MAKEFILE["machines"])
    ap.add_argument("--tasks", type=int, default=MAKEFILE["tasks"])
    ap.add_argument("--rounds", type=int, default=MAKEFILE["rounds"])
    ap.add_argument("--warmup", type=int, default=MAKEFILE["warmup"])
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks (gloo; they may share one card)")
    ap.add_argument("--seed", type=int, default=MAKEFILE["seed"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    payload = dict(machines=args.machines, tasks=args.tasks, rounds=args.rounds,
                   warmup=args.warmup, seed=args.seed, verbose=args.verbose,
                   device=args.device)
    got = run_ranks("ksched_tpu_torch.tools.shard_smoke:rank_smoke", args.devices,
                    payload, deadline_s=900, timeout_s=300)
    for line in got[0]["log"]:
        log(line)
    keys = ("scan_csr", "sharded", "chaos")
    for r, g in enumerate(got[1:], 1):
        assert {k: g[k] for k in keys} == {k: got[0][k] for k in keys}, (
            f"rank {r} differs from rank 0")
    log(f"shard-smoke: {args.devices} ranks ({got[0]['backend']}) agree; rank walls "
        f"{[round(g['wall_s'], 1) for g in got]} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
