"""The JAX package's values for chip_smoke.py's general-graph phases.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_event_mega_reference.py [W|P|WP] [machines tasks [rounds]]

Runs event-path scenarios through the JAX package's FlowScheduler on
the CPU and prints one JSON object per scenario, per round: tasks
placed, the AutoSolver path (where there is one), supersteps, objective
and the sha256 of the sorted task bindings; a round that stalls is
recorded with its path and the stalled rung's `last_supersteps` (and,
on graphs of at most 8,192 nodes, the cpu_ref objective of the stalled
round's problem) and ends the scenario. With soltel on (the default;
KSCHED_SOLTEL=0 turns it off, and the flows do not depend on it) a round
on the mega path also records the sha256 of its solve's soltel ring
(`telemetry_sha256`, the formula of ksched_tpu_torch.drivers.churn's),
and a stall its SolverStallError's `reason`. Defaults: W and P, 1,000
machines, 10,000 tasks, 3 rounds.

- W: Scenario W (Whare-Map, mixed task classes) with
  MegaSolver(fallback=JaxSolver()), the JAX package's
  make_backend("mega"), rounds 0-2 (round 3 oversubscribes the cluster
  and stalls the warm and the cost-scaling attempt alike);
- P: Scenario P (trivial model, preemption on) with
  AutoSolver(JaxSolver(), mega=MegaSolver()), rounds 0-2;
- WP: Scenario W with preemption on, through AutoSolver(JaxSolver())
  (the JAX "auto" ladder with the scan-CSR solve as its general rung).

The Pallas interpreter is far too slow for these solves, so inside this
process only `mcmf_loop_pallas` is replaced by `mega_standin`: it
rebuilds the CSR tables from the MegaPlan's entry tables and runs the
scan-CSR `_solve_mcmf`, whose outputs the kernel reproduces bit for bit
(tests/test_mega_solver.py; tests/test_torch_mega.py holds the stand-in
equal to the interpreted kernel). Asked for the kernel's telemetry ring,
the stand-in returns the scan-CSR solve's ring at the kernel's clamped
capacity (`mega_telemetry_cap`): the two rings agree superstep for
superstep (tests/test_soltel.py; tests/test_torch_soltel.py holds the
stand-in's ring equal to the interpreted kernel's). A few minutes at 1k
machines and 10k tasks.
"""

import hashlib
import json
import sys

import numpy as np
import jax.numpy as jnp

from ksched_tpu.costmodels import WhareMapCostModel
from ksched_tpu.data import TaskType
from ksched_tpu.drivers import add_job, build_cluster
from ksched_tpu.solver.jax_solver import _solve_mcmf
from ksched_tpu.utils import seed_rng


def mega_standin(cap, cost, supply, flow0, eps_init, e_arc, e_sign, e_src,
                 e_hs, e_he, e_prow, e_pcol, fwd_pos, R, L, alpha=8,
                 max_supersteps=50_000, tighten_sweeps=32, interpret=False,
                 telemetry_cap=0):
    """`mcmf_loop_pallas` through the scan-CSR solve: the same
    (steps, converged, p_overflow) and the same flow on the M real
    arcs (zeros past them, which MegaSolver drops); with telemetry_cap
    the scan-CSR solve's soltel ring at the kernel's clamped capacity."""
    from ksched_tpu.ops.mcmf_pallas import mega_telemetry_cap

    if telemetry_cap:
        telemetry_cap = mega_telemetry_cap(R, L, telemetry_cap)
    sign = np.asarray(e_sign)
    m2 = int((sign != 0).sum())  # the live entries lead, pads trail
    m = m2 // 2
    ppos = np.asarray(e_prow, np.int64) * L + np.asarray(e_pcol)
    s_arc = np.asarray(e_arc)[:m2]
    s_sign = sign[:m2]
    s_src = np.asarray(e_src)[:m2]
    s_dst = np.asarray(e_src)[ppos[:m2]]
    s_isstart = np.asarray(e_hs)[:m2] != 0
    idx = np.arange(m2, dtype=np.int32)
    s_segstart = np.maximum.accumulate(np.where(s_isstart, idx, 0)).astype(np.int32)
    inv_order = np.empty(m2, np.int32)
    inv_order[np.where(s_sign > 0, s_arc, s_arc + m)] = idx
    n = int(supply.shape[0])
    row_ptr = np.zeros(n + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(s_src, minlength=n))
    node_first = np.minimum(row_ptr[:-1], m2 - 1).astype(np.int32)
    node_last = np.maximum(row_ptr[1:] - 1, 0).astype(np.int32)
    node_nonempty = row_ptr[1:] > row_ptr[:-1]
    plan = tuple(jnp.asarray(x) for x in (
        s_arc, s_sign, s_src, s_dst, s_segstart, s_isstart, inv_order,
        node_first, node_last, node_nonempty))
    flow, _p, steps, conv, povf, *tel = _solve_mcmf(
        cap[:m], cost[:m], supply, flow0[:m], eps_init, *plan,
        alpha=alpha, max_supersteps=max_supersteps,
        tighten_sweeps=tighten_sweeps, telemetry_cap=telemetry_cap,
    )
    out = np.zeros(len(fwd_pos), np.int32)
    out[:m] = np.asarray(flow)
    return (jnp.asarray(out), steps, conv, povf, *tel)


def telemetry_sha256(tel):
    """sha256 of a decoded soltel ring, as ksched_tpu_torch.drivers.churn
    computes it (None without one)."""
    if tel is None:
        return None
    return hashlib.sha256(json.dumps(tel.to_dict(), sort_keys=True).encode()).hexdigest()


def bindings_sha256(sched) -> str:
    """sha256 of the sorted (task id, resource id) bindings."""
    rows = sorted((int(t), str(r)) for t, r in sched.get_task_bindings().items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def scenario_rounds(name, num_machines, num_tasks, backend, seed=7):
    """Scenario W (name "W"), P ("P") or W with preemption on ("WP") on
    the JAX package, round by round: yields (round, scheduler, placed).
    The port's twins of W and P are ksched_tpu_torch.drivers.
    whare_mixed_rounds / trivial_preempt_rounds."""
    seed_rng(seed)
    whare = name != "P"
    sched, _r, jmap, tmap, _root = build_cluster(
        num_machines=num_machines, num_cores=1, pus_per_core=4,
        max_tasks_per_pu=4, backend=backend,
        cost_model_factory=WhareMapCostModel if whare else None,
        preemption=name != "W",
    )
    seen = set()
    waves = (num_tasks // 10, num_tasks // 40, num_tasks // 40, num_tasks // 40)
    for r, per_job in enumerate(waves):
        for _ in range(10):
            add_job(sched, jmap, tmap, num_tasks=per_job)
        if whare:
            rng = np.random.default_rng(r)
            for uid, td in tmap.unsafe_get().items():
                if uid in seen:
                    continue
                seen.add(uid)
                td.task_type = TaskType(int(rng.integers(0, 4)))
        placed, _ = sched.schedule_all_jobs()
        yield r, sched, placed


def make_solver(name):
    from ksched_tpu.solver.graph_collapse import AutoSolver
    from ksched_tpu.solver.jax_solver import JaxSolver
    from ksched_tpu.solver.mega_solver import MegaSolver

    if name == "W":
        return MegaSolver(fallback=JaxSolver())
    if name == "WP":
        return AutoSolver(JaxSolver())
    return AutoSolver(JaxSolver(), mega=MegaSolver())


def reference(name, num_machines, num_tasks, rounds=3) -> dict:
    """Per-round values of scenario `name`, the first `rounds` rounds;
    a stall is recorded under "stall" and ends the run. Needs
    `mcmf_loop_pallas` replaced by `mega_standin` (main() does)."""
    from ksched_tpu.obs.soltel import SolverStallError
    from ksched_tpu.solver.cpu_ref import ReferenceSolver

    from ksched_tpu.obs import soltel

    backend = make_solver(name)
    keys = ["placed", "path", "supersteps", "objective", "bindings_sha256"]
    if soltel.enabled():
        keys.append("telemetry_sha256")
    out = {k: [] for k in keys}
    run = scenario_rounds(name, num_machines, num_tasks, backend)
    sched = None
    for _ in range(rounds):
        try:
            r, sched, placed = next(run)
        except SolverStallError as e:
            path = getattr(backend, "last_path", "mega")
            rung = {"mega": getattr(backend, "mega", backend),
                    "csr": getattr(backend, "csr", None)}[path]
            out["stall"] = {"round": len(out["placed"]), "path": path,
                            "last_supersteps": int(rung.last_supersteps)}
            if e.reason is not None:
                out["stall"]["reason"] = e.reason
            problem = sched.solver.state.problem() if sched else None
            if problem is not None and problem.num_nodes <= 8192:
                out["stall"]["cpu_ref_objective"] = int(
                    ReferenceSolver().solve(problem).objective)
            break
        out["placed"].append(int(placed))
        out["path"].append(getattr(backend, "last_path", "mega"))
        out["supersteps"].append(int(backend.last_supersteps))
        out["objective"].append(int(sched.solver.last_result.objective))
        out["bindings_sha256"].append(bindings_sha256(sched))
        if "telemetry_sha256" in out:
            mega = out["path"][-1] == "mega"
            out["telemetry_sha256"].append(
                telemetry_sha256(backend.last_telemetry) if mega else None)
    return out


def main(argv) -> int:
    import ksched_tpu.ops.mcmf_pallas as mcmf_pallas

    mcmf_pallas.mcmf_loop_pallas = mega_standin
    names = [a for a in argv if a in ("W", "P", "WP")] or ["W", "P"]
    sizes = [int(a) for a in argv if a.isdigit()] or [1000, 10000]
    for name in names:
        print(json.dumps({name: reference(name, *sizes)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
