"""Shared cases of the port's static-analysis tests: how the registry's
(program, check) pairs split between the three CPU files, and the rank
side of tests/test_torch_analysis_sharded.py (it imports the port only,
so spawned ranks can run it)."""

from ksched_tpu_torch.analysis import engine
from ksched_tpu_torch.analysis.program_registry import PROGRAMS

#: every (program, check) the engine applies on the CPU
ALL_PAIRS = [(s.name, c) for s in PROGRAMS.values() for c in engine.applicable_checks(s)]

#: the pairs that need the ranks of a process group
SHARDED_PAIRS = [(n, c) for n, c in ALL_PAIRS if engine.needs_ranks(PROGRAMS[n], c)]

#: the dense and ELL solves' pairs, in tests/test_torch_analysis_solves.py
#: (each file of tier-1 stays under about a minute)
SOLVE_PROGRAMS = ("ell_solve", "layered_solve")
SOLVE_PAIRS = [(n, c) for n, c in ALL_PAIRS
               if n in SOLVE_PROGRAMS and (n, c) not in SHARDED_PAIRS]

#: the rest, in tests/test_torch_program_registry.py
REGISTRY_PAIRS = [p for p in ALL_PAIRS if p not in SHARDED_PAIRS and p not in SOLVE_PAIRS]


def pair_id(pair) -> str:
    return f"{pair[0]}-{pair[1]}"


def _sharded_layered(mesh, tiered: bool):
    """The sharded layered solve (parallel/sharded_transport.py) on this
    rank, recorded: its collectives a superstep and a refinement wave."""
    from ksched_tpu_torch.analysis import op_contracts as oc
    from ksched_tpu_torch.parallel import sharded_transport as st

    args, eps = oc._layered_args(4, 100, 0, tiered, "cpu")
    if tiered:
        rec = oc.record(lambda: st.sharded_transport_solve_tiered(
            mesh, *args, eps, refine_waves=1))
    else:
        rec = oc.record(lambda: st.sharded_transport_solve(mesh, *args, eps))
    rep = rec.report()
    by_kind = {}
    for seg in rec.segments:
        if seg.kind is not None:
            cur = by_kind.setdefault(seg.kind, {})
            for k, n in seg.collectives.items():
                cur[k] = max(cur.get(k, 0), n)
    return {"loop": by_kind, "iterations": dict(rep.loop_iterations),
            "converged": bool(rec.outputs[2])}


def sharded_cases(rank, world, payload):
    """Every sharded (program, check) through the engine, then the
    recorded collective counts the tests compare with the JAX registry:
    the slot-stable solve's a loop iteration, telemetry off and on, its
    warm variant's, and the sharded layered solve's (plain and tiered)."""
    from ksched_tpu_torch.analysis import op_contracts as oc
    from ksched_tpu_torch.parallel.mesh import ShardMesh

    out = {"checks": engine.rank_checks(rank, world, SHARDED_PAIRS)}
    oc.MESH = mesh = ShardMesh(device="cpu")
    try:
        for name in ("sharded_slot_solve", "sharded_slot_solve_warmp", "sharded_solve"):
            spec = PROGRAMS[name]
            rep = engine.report(spec)
            out[name] = {"loop": dict(rep.collectives_loop),
                         "total": dict(rep.collectives_total),
                         "iterations": dict(rep.loop_iterations)}
            if spec.telemetry_knob:
                on = engine.report(spec, **{spec.telemetry_knob: 512})
                out[name]["loop_on"] = dict(on.collectives_loop)
        out["layered"] = _sharded_layered(mesh, tiered=False)
        out["layered_tiered"] = _sharded_layered(mesh, tiered=True)
    finally:
        oc.MESH = None
    return out
