"""The rank side of the multi-device tests: what each rank of a gloo group
computes with ksched_tpu_torch/parallel/ on the CPU, started by
ksched_tpu_torch/parallel/launch.py's `run_ranks` (one spawn per test
module, all of the module's cases in it). Imports the port only: the tests compare
what the ranks return with the JAX package in the parent.

Every `*_cases(rank, world, payload)` runs on `world` = 4 ranks: the D =
4 cases on the whole group, the D = 2 cases on the subgroup of ranks 0
and 1 (a ShardMesh takes whatever group it is given), and returns a
dict of numpy arrays and ints keyed by case name.
"""

from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def _groups(world):
    """{D: ShardMesh or None (this rank is not a member)} for D = 2 (ranks
    0 and 1) and D = world (all). Every rank creates every group."""
    from datetime import timedelta

    import torch.distributed as dist

    from ksched_tpu_torch.parallel.mesh import ShardMesh

    g2 = dist.new_group([0, 1], timeout=timedelta(seconds=60))
    meshes = {world: ShardMesh(None, device=CPU)}
    meshes[2] = ShardMesh(g2, device=CPU) if dist.get_rank() < 2 else None
    return meshes


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_mesh.py
# ---------------------------------------------------------------------------


def rank_values(seed, rank, shape):
    """The int32 tensor rank `rank` contributes to a collective case."""
    rng = np.random.default_rng(seed * 100 + rank)
    return rng.integers(-1000, 1000, shape).astype(np.int32)


def mesh_cases(rank, world, payload):
    from datetime import timedelta

    import torch.distributed as dist

    from ksched_tpu_torch.parallel.mesh import CollectiveError, ShardMesh, global_excl_prefix

    out = {}
    meshes = _groups(world)
    for D, mesh in sorted(meshes.items(), reverse=True):
        if mesh is None:
            continue
        x = torch.tensor(rank_values(D, mesh.rank, (3, 5)))
        mesh.reset_counts()
        out[f"psum{D}"] = _np(mesh.psum(x, "a"))
        out[f"pmax{D}"] = _np(mesh.pmax(x, "a"))
        out[f"pmin{D}"] = _np(mesh.pmin(x, "b"))
        out[f"scalar{D}"] = _np(mesh.psum(x[0, 0], "b"))
        out[f"gather{D}"] = _np(mesh.all_gather(x, "b"))
        out[f"any{D}"] = (bool(mesh.any(x > 990, "c")), bool(mesh.any(x > 5000, "c")))
        out[f"counts{D}"] = (mesh.totals(), mesh.by_site())
        cols = torch.tensor(rank_values(D + 7, mesh.rank, (2, 6)))
        out[f"prefix{D}"] = _np(global_excl_prefix(mesh, cols, "p"))
        big = torch.full((4,), (1 << 31) - 1 - mesh.rank, dtype=torch.int32)
        out[f"wrap{D}"] = _np(mesh.psum(big, "w"))
        out[f"rank{D}"] = (mesh.rank, mesh.size, mesh.backend)
    # a member that waits alone: rank 0 issues a collective on a group
    # with a 2 s timeout in which rank 1 never takes part
    g_short = dist.new_group([0, 1], timeout=timedelta(seconds=2))
    if rank == 0:
        lone = ShardMesh(g_short, device=CPU)
        try:
            lone.psum(torch.ones(1, dtype=torch.int32), "lone")
            out["timeout"] = "no error"
        except CollectiveError as e:
            out["timeout"] = f"CollectiveError: {e}"[:200]
    # a rank outside a group is refused
    g_other = dist.new_group([1, 2], timeout=timedelta(seconds=60))
    if rank == 0:
        try:
            ShardMesh(g_other, device=CPU)
            out["outsider"] = "accepted"
        except ValueError as e:
            out["outsider"] = f"ValueError: {e}"
    # the whole group meets here: nobody leaves before rank 0's timeout
    meshes[world].psum(torch.zeros(1, dtype=torch.int32), "meet")
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_transport.py
# ---------------------------------------------------------------------------

#: (C, M, Mp, seed) of the plain instances
PLAIN = ((2, 30, 256, 0), (2, 30, 256, 1), (3, 60, 256, 0))
#: (C, M, Mp, seed, refine_waves) of the tiered instances
TIERED = ((2, 30, 256, 0, 8), (2, 30, 256, 1, 8), (3, 60, 256, 2, 8),
          (2, 30, 1024, 0, 0))


def transport_instance(C, M, Mp, seed):
    """(wS, supply, col_cap, eps0) int32 numpy, a padded transport
    problem with n_scale-scaled costs (eps0 = the full range)."""
    from ksched_tpu_torch.solver.layered import pad_geometry

    rng = np.random.default_rng(seed)
    _mp, n_scale = pad_geometry(M, C)
    w = np.zeros((C, Mp), np.int64)
    w[:, :M] = rng.integers(-30, 5, (C, M))
    supply = rng.integers(1, 4 * M // C + 2, C).astype(np.int32)
    cap = np.zeros(Mp, np.int32)
    cap[:M] = rng.integers(0, 4, M)
    cap[-1] = supply.sum()
    wS = (w * n_scale).astype(np.int32)
    return wS, supply, cap, int(max(1, np.abs(wS).max()))


def tiered_instance(C, M, Mp, seed):
    """(wLo, wHi, R, supply, col_cap, eps0): transport_instance's costs
    as the dear tier, 3 cost units cheaper for the first R units."""
    from ksched_tpu_torch.solver.layered import pad_geometry

    wS, supply, cap, eps0 = transport_instance(C, M, Mp, seed)
    R = np.random.default_rng(seed + 9).integers(0, 2, (C, Mp)).astype(np.int32)
    wLo = (wS - 3 * pad_geometry(M, C)[1]).astype(np.int32)
    return wLo, wS, R, supply, cap, eps0


def layered_problems():
    """LayeredProblem field dicts: a contended multi-class instance, a
    single class and a class-degenerate one (the closed forms)."""
    rng = np.random.default_rng(4)
    C, M = 3, 20
    out = {
        "multi": dict(supply=rng.integers(5, 30, C).astype(np.int32),
                      col_cap=rng.integers(0, 4, M).astype(np.int32),
                      cost_cm=rng.integers(0, 12, (C, M)).astype(np.int32),
                      unsched_cost=20, ec_cost=2),
        "single": dict(supply=np.array([17], np.int32),
                       col_cap=rng.integers(0, 4, M).astype(np.int32),
                       cost_cm=rng.integers(0, 12, (1, M)).astype(np.int32),
                       unsched_cost=20, ec_cost=2),
    }
    row = rng.integers(0, 12, M).astype(np.int32)
    out["degenerate"] = dict(supply=np.array([9, 4, 7], np.int32),
                             col_cap=rng.integers(0, 4, M).astype(np.int32),
                             cost_cm=np.tile(row, (3, 1)),
                             unsched_cost=20, ec_cost=2)
    return out


def transport_cases(rank, world, payload):
    from ksched_tpu_torch.parallel.sharded_transport import (
        ShardedLayeredSolver,
        sharded_transport_solve,
        sharded_transport_solve_tiered,
    )
    from ksched_tpu_torch.solver.layered import LayeredProblem

    t = torch.tensor
    out = {}
    for D, mesh in sorted(_groups(world).items(), reverse=True):
        if mesh is None:
            continue
        mesh.reset_counts()
        steps_total = 0
        for C, M, Mp, seed in PLAIN:
            wS, sup, cap, eps0 = transport_instance(C, M, Mp, seed)
            y, steps, conv = sharded_transport_solve(mesh, t(wS), t(sup), t(cap), eps0)
            out[f"plain{D}_{C}_{M}_{Mp}_{seed}"] = (_np(y), steps, conv)
            steps_total += steps
        out[f"per_superstep{D}"] = (mesh.by_site(), steps_total)
        for C, M, Mp, seed, waves in TIERED:
            wLo, wHi, R, sup, cap, eps0 = tiered_instance(C, M, Mp, seed)
            y, steps, conv = sharded_transport_solve_tiered(
                mesh, t(wLo), t(wHi), t(R), t(sup), t(cap), eps0, refine_waves=waves)
            out[f"tiered{D}_{C}_{M}_{Mp}_{seed}_{waves}"] = (_np(y), steps, conv)
        solver = ShardedLayeredSolver(mesh)
        for name, lp in layered_problems().items():
            res = solver.solve_layered(LayeredProblem(**lp))
            out[f"layered{D}_{name}"] = (res.y, res.objective, res.num_unsched,
                                         res.supersteps, solver.last_supersteps)
        try:
            sharded_transport_solve(mesh, t(np.zeros((2, 255), np.int32)),
                                    t(np.ones(2, np.int32)),
                                    t(np.ones(255, np.int32)), 1)
            out[f"indivisible{D}"] = "accepted"
        except ValueError as e:
            out[f"indivisible{D}"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_solver.py
# ---------------------------------------------------------------------------

#: the churn drive: (tasks, machines, machine capacities, rounds)
DRIVE = dict(tasks=6, machines=5, machine_cap=(6, 10), rounds=6)
#: the driver's cut: sharded_scale at a test size
SCALE = dict(tasks=400, machines=40, rounds=4, warmup=2, churn=0.01,
             burst_every=4, burst_factor=10, restart_budget=64)


def legacy_problems():
    """Plain FlowProblem field dicts: tasks -> machines -> sink with an
    escape, seeded (the legacy argsort path's inputs)."""
    from ksched_tpu_torch.drivers.synthetic import random_flow_problem

    return [random_flow_problem(rng, *legacy_shape(rng)) for rng in legacy_rngs()]


def legacy_rngs():
    return [np.random.default_rng(seed) for seed in (11,)]


def legacy_shape(rng):
    """(tasks, machines, slots per machine), drawn first from `rng`."""
    return (int(rng.integers(5, 14)), int(rng.integers(2, 5)), int(rng.integers(1, 4)))


def drive_rounds(make_solver, resident=False, mesh=None, rounds=DRIVE["rounds"],
                 mirror_device=None):
    """The slot-stable churn drive of the JAX package's sharded tests
    (tests/test_sharded_fast.py `_drive`) on the port: rows of (flow,
    supersteps, objective, warm scope, plan kind). The resident mirror
    is made on `mirror_device`, else on the mesh's device, else the CPU."""
    from torch_plan_twin import SCRIPT, Solo, churn_round

    from ksched_tpu_torch.graph.device_export import DeviceResidentState

    solo = Solo(DRIVE["tasks"], DRIVE["machines"], machine_cap=DRIVE["machine_cap"])
    st = solo.t
    if mirror_device is None:
        mirror_device = mesh.device if mesh is not None else CPU
    res = DeviceResidentState(st, mirror_device) if resident else None
    if mesh is not None:
        res.enable_sharded_plan(mesh)
    solver = make_solver()
    rng = np.random.default_rng(7)
    rows = []
    for rnd in range(rounds + 1):
        if rnd:
            churn_round(solo, SCRIPT[(rnd - 1) % len(SCRIPT)], rng)
        prob = res.refresh() if resident else st.problem()
        r = solver.solve(prob)
        p = getattr(solver, "_prev_p", None)
        rows.append((np.asarray(r.flow).copy(), int(solver.last_supersteps),
                     int(r.objective), solver.last_warm_scope,
                     res.last_plan_kind if res is not None else None,
                     None if p is None else _np(p)))
        if not st.plan.needs_rebuild:
            st.plan.check_invariants()
    return rows, st, res, solver


def solver_cases(rank, world, payload):
    import warnings

    from ksched_tpu_torch.drivers.sharded_scale import run_sharded_scale
    from ksched_tpu_torch.parallel.sharded_solver import (
        ShardedJaxSolver,
        csr_working_set_bytes,
        sharded_shard_bytes,
    )
    from ksched_tpu_torch.runtime.degrade import build_degradation_ladder
    from ksched_tpu_torch.runtime.integrity import FP_PLAN_ARRAYS, host_fingerprint
    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.solver.graph_collapse import AutoSolver
    from ksched_tpu_torch.solver.select import make_backend

    out = {}
    meshes = _groups(world)
    for D, mesh in sorted(meshes.items(), reverse=True):
        if mesh is None:
            continue
        # slot-stable, the plan's own upload
        rows, _st, _res, solver = drive_rounds(lambda: ShardedJaxSolver(mesh))
        out[f"slot{D}"] = (rows, solver.last_path)
        # legacy argsort path, warm rounds included
        sh = ShardedJaxSolver(mesh)
        leg = []
        for p in legacy_problems():
            r1 = sh.solve(p)
            s1 = sh.last_supersteps
            p.cost = p.cost.copy()
            p.cost[0] += 3  # a cost perturbation: the warm re-solve
            r2 = sh.solve(p)
            leg.append((r1.flow, r1.objective, s1, r2.flow, r2.objective,
                        sh.last_supersteps, sh.last_path))
        out[f"legacy{D}"] = leg
        # one ring, on the legacy path and the slot-stable path
        tel_rows = []
        for p in legacy_problems()[:1]:
            s = ShardedJaxSolver(mesh, telemetry=64)
            s.solve(p)
            tel_rows.append(s.last_telemetry.to_dict())
        rows_t, _st, _res, st_solver = drive_rounds(
            lambda: ShardedJaxSolver(mesh, telemetry=64), rounds=1)
        tel_rows.append(st_solver.last_telemetry.to_dict())
        out[f"ring{D}"] = tel_rows
    mesh2 = meshes[2]
    if mesh2 is not None:
        # the sharded mirror: delta-sized rounds, parity, fingerprints
        rows, st, res, _s = drive_rounds(lambda: ShardedJaxSolver(mesh2),
                                         resident=True, mesh=mesh2)
        res.parity_check()
        res.plan_parity_check()
        fps = res.plan_fingerprints()
        out["resident2"] = (rows, [int(fps[i]) == host_fingerprint(getattr(st.plan, n))
                                   for i, n in enumerate(FP_PLAN_ARRAYS)],
                            tuple(res.d_p_arc.shape), st.plan.block_extent)
        # the single-device rung on a sharded mirror (the ladder's jax
        # rung and the too-big-per-shard CSR fallback)
        rows_c, _st, _res, _s = drive_rounds(
            lambda: CsrSolver(device=CPU, restart_budget=64), resident=True, mesh=mesh2)
        out["csr_on_sharded_mirror2"] = rows_c
        # AutoSolver's fitting gate
        from torch_plan_twin import Solo

        solo = Solo(DRIVE["tasks"], DRIVE["machines"], machine_cap=DRIVE["machine_cap"])
        prob = solo.t.problem()
        n_cap, m_cap = prob.num_nodes, len(prob.src)
        budget = (sharded_shard_bytes(n_cap, m_cap, 2) + csr_working_set_bytes(n_cap, m_cap)) // 2
        made = []

        def factory():
            made.append(1)
            return ShardedJaxSolver(mesh2)

        base_auto = AutoSolver(CsrSolver(device=CPU), device=CPU)
        base = base_auto.solve(prob)
        auto = AutoSolver(CsrSolver(device=CPU), device=CPU, sharded=factory,
                          hbm_budget_bytes=budget)
        res_a = auto.solve(solo.t.problem())
        auto_default = AutoSolver(CsrSolver(device=CPU), device=CPU, sharded=factory)
        auto_default.solve(solo.t.problem())
        out["gate2"] = (base_auto.last_path, base.flow, auto.last_path, res_a.flow,
                        len(made), auto_default.last_path, budget)
        # the ladder's sharded -> jax step

        class FailingOnce(ShardedJaxSolver):
            fails = 0

            def solve(self, problem):
                if FailingOnce.fails == 0:
                    FailingOnce.fails += 1
                    raise RuntimeError("injected sharded-rung failure")
                return super().solve(problem)

        ladder = build_degradation_ladder(FailingOnce(mesh2), "sharded", device=CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r1 = ladder.solve(solo.t.problem())
        first = ladder.last_rung_name
        r2 = ladder.solve(solo.t.problem())
        out["ladder2"] = (ladder.rung_names(), first, ladder.last_rung_name,
                          r1.objective, r2.objective)
        # the driver, both arms, at a test size
        scale = run_sharded_scale(mesh2, device=CPU, **SCALE)
        scale.pop("objects")
        out["scale2"] = scale
    # make_backend over the default group (all ranks)
    sb = make_backend("sharded", device="cpu")
    ab = make_backend("auto", device="cpu")
    out["backends"] = (type(sb).__name__, sb.num_shards, ab._sharded is not None,
                       type(ab.sharded).__name__, ab.sharded.num_shards)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_plan.py (the mirror and the integrity audit)
# ---------------------------------------------------------------------------


def mirror_cases(rank, world, payload):
    """The sharded resident mirror over the churn script at D = 2 and
    4: per round the plan kind, the global and per-rank plan bytes, the
    fingerprints against the host twins, the mirror's blocks against the
    host plan's; then a poison flip of one entry element, the audit and
    the repair."""
    from torch_plan_twin import SCRIPT, Solo, churn_round

    from ksched_tpu_torch.graph.device_export import DeviceResidentState
    from ksched_tpu_torch.parallel.sharded_solver import gather_block
    from ksched_tpu_torch.runtime.integrity import (
        FP_PLAN_ARRAYS,
        StateAuditor,
        apply_device_corruption,
        host_fingerprint,
    )

    out = {}
    for D, mesh in sorted(_groups(world).items(), reverse=True):
        if mesh is None:
            continue
        solo = Solo(16, 4, machine_cap=(16, 20))
        st = solo.t
        st.plan.enable_sharding(D)
        st.plan.ensure_built()
        res = DeviceResidentState(st, CPU)
        res.enable_sharded_plan(mesh)
        rng = np.random.default_rng(5)
        rows = []
        for rnd in range(len(SCRIPT) + 1):
            if rnd:
                churn_round(solo, SCRIPT[(rnd - 1) % len(SCRIPT)], rng)
            prob = res.refresh()
            fps = res.plan_fingerprints()
            blocks = [gather_block(mesh, t) for t in prob.d_plan_shard[:6]]
            rows.append((res.last_plan_kind, res.last_plan_bytes,
                         res.last_plan_rank_bytes, res.last_plan_records,
                         [int(f) for f in fps],
                         [int(f) == host_fingerprint(getattr(st.plan, n))
                          for f, n in zip(fps, FP_PLAN_ARRAYS)],
                         [bool(np.array_equal(b, h.astype(b.dtype)))
                          for b, h in zip(blocks, st.plan.host_args()[:6])],
                         prob.d_plan is None, tuple(prob.d_plan_shard[0].shape),
                         res.last_upload_bytes))
        res.plan_parity_check()
        auditor = StateAuditor(res)
        clean = auditor.audit()
        apply_device_corruption(res, {"array": "p_sign", "index": 3 * st.plan.block_extent // 2,
                                      "bit": 4})
        diverged = auditor.audit()
        diffs = [str(e)[:120] for e in auditor.diffs(diverged)]
        res._upload_plan_full(st.plan)  # the reupload rung
        repaired = auditor.audit()
        out[f"mirror{D}"] = dict(rows=rows, clean=clean, diverged=diverged,
                                 diffs=diffs, repaired=repaired,
                                 block_extent=st.plan.block_extent,
                                 entry_cap=st.plan.entry_cap)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_cuda_parallel.py (card only)
# ---------------------------------------------------------------------------


def cuda_cases(rank, world, payload):
    """On the card over gloo: the mesh's collectives on CUDA tensors, and
    the slot-stable churn drive with the mesh on the card and on the CPU
    (one group reduces both)."""
    from ksched_tpu_torch.parallel.mesh import ShardMesh, global_excl_prefix
    from ksched_tpu_torch.parallel.sharded_solver import ShardedJaxSolver

    card = torch.device("cuda", 0)
    mesh = ShardMesh(None, device=card)
    x = torch.tensor(rank_values(world, rank, (3, 5)), device=card)
    cols = torch.tensor(rank_values(world + 7, rank, (2, 6)), device=card)
    out = {
        "psum": _np(mesh.psum(x)), "pmax": _np(mesh.pmax(x)), "pmin": _np(mesh.pmin(x)),
        "gather": _np(mesh.all_gather(x)), "prefix": _np(global_excl_prefix(mesh, cols)),
        "backend": mesh.backend,
    }
    cpu_mesh = ShardMesh(None, device=CPU)
    for name, m in (("card", mesh), ("cpu", cpu_mesh)):
        rows, _st, _res, _s = drive_rounds(lambda: ShardedJaxSolver(m))
        out[f"slot_{name}"] = rows
        rows_r, _st, _res, _s = drive_rounds(lambda: ShardedJaxSolver(m), resident=True,
                                             mesh=m, rounds=3)
        out[f"resident_{name}"] = rows_r
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_cuda_default_device.py (the card, default devices)
# ---------------------------------------------------------------------------


def _solo_problem():
    from torch_plan_twin import Solo

    solo = Solo(DRIVE["tasks"], DRIVE["machines"], machine_cap=DRIVE["machine_cap"])
    return solo.t.problem()


def _solved(solver, result):
    """(flow, objective, supersteps, potentials) of a solve."""
    p = getattr(solver, "_prev_p", None)
    return (np.asarray(result.flow).copy(), int(result.objective),
            int(solver.last_supersteps), None if p is None else _np(p))


def default_device_cases(rank, world, payload):
    """The sharded rung on the entry points' default device (no device
    argument anywhere but where a case names one on purpose), each
    against the single-card CsrSolver on its own default: the churn
    drive through make_backend("sharded"); make_backend("auto") whose
    fitting gate escalates; build_degradation_ladder over
    make_backend("sharded"); a mirror made on "cuda" taking a mesh made
    on "cuda:0". A case that raises is kept as its error under
    out["errors"][case], and the others still run."""
    import os

    from ksched_tpu_torch.parallel.mesh import ShardMesh
    from ksched_tpu_torch.parallel.sharded_solver import (
        ShardedJaxSolver,
        csr_working_set_bytes,
        sharded_shard_bytes,
    )
    from ksched_tpu_torch.runtime.degrade import build_degradation_ladder
    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.solver.select import make_backend

    out = {"errors": {}}

    def case(name, fn):
        import traceback

        try:
            out[name] = fn()
        except Exception:  # kept, with where it was raised, for the test to show
            out["errors"][name] = "".join(traceback.format_exc().splitlines(True)[-6:])
        # the ranks meet after every case, so a case that failed on one
        # rank only fails that case
        ShardMesh(None, device="cpu").psum(torch.zeros(1, dtype=torch.int32), "meet")

    out["csr"] = drive_rounds(lambda: CsrSolver(restart_budget=64))[0]
    csr = CsrSolver()
    out["auto_csr"] = _solved(csr, csr.solve(_solo_problem()))

    # the churn drive, sharded on its default against the single card
    def sharded():
        solver = make_backend("sharded")
        return ((str(solver.mesh.device), str(solver.device)),
                drive_rounds(lambda: solver)[0])

    case("sharded", sharded)

    # make_backend("auto"): the mega rung refuses at a budget below this
    # graph's live set (as it refuses a graph beyond the card's L2), and
    # the fitting gate's budget sits between the per-shard and the
    # single-card working sets, so the solve escalates to the sharded rung
    def auto():
        prob = _solo_problem()
        n_cap, m_cap = prob.num_nodes, len(prob.src)
        budget = (sharded_shard_bytes(n_cap, m_cap, world)
                  + csr_working_set_bytes(n_cap, m_cap)) // 2
        os.environ["KSCHED_HBM_BUDGET"] = str(budget)
        try:
            solver = make_backend("auto")
        finally:
            del os.environ["KSCHED_HBM_BUDGET"]
        solver.mega.budget_bytes = 0
        lazy = (solver._sharded is not None
                and not isinstance(solver._sharded, ShardedJaxSolver))
        res = solver.solve(prob)
        return (solver.last_path, lazy, solver.hbm_budget_bytes == budget,
                solver.last_mega_refusal, str(solver.sharded.mesh.device),
                _solved(solver.sharded, res))

    case("auto", auto)

    # the degradation ladder over the sharded rung, on its defaults
    def ladder():
        solver = build_degradation_ladder(make_backend("sharded"), "sharded")
        rung = solver._rungs[0][1]
        res = solver.solve(_solo_problem())
        return (solver.rung_names(), solver.last_rung_name,
                solver.degradations_total, _solved(rung, res))

    case("ladder", ladder)

    # a mirror on "cuda" and a mesh on "cuda:0"
    def mirror():
        mesh0 = ShardMesh(None, device="cuda:0")
        rows, _st, res, _s = drive_rounds(lambda: ShardedJaxSolver(mesh0), resident=True,
                                          mesh=mesh0, mirror_device="cuda")
        return (str(res.device), str(mesh0.device), res._shard is mesh0, rows)

    case("mirror", mirror)
    return out
