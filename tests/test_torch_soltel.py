"""The solver-interior telemetry of the port (ksched_tpu_torch/obs/soltel.py
and the rings of the csr, ell, mega and layered solves) against the JAX
package's (ksched_tpu/obs/soltel.py), bit for bit (tolerance 0: the
rings are int32 and the decodes, stall reasons and events are integers
and text):

- decode, detect_stall, failure_reason and warm_price_war on the same
  numpy rings (full, wrapped, truncated) in both packages;
- the rings of CsrSolver (slot-stable plan, a ring that wraps, a
  warm_price_war under a small restart budget), EllSolver, the layered
  transport's plain loop and the mcmf kernel's plain version (against
  the Pallas kernel run by its interpreter, a clamped cap among them)
  against the JAX package's;
- flows bit-identical with the ring on and off in the port;
- SolverStallError's reason and tail under a budget that cannot
  converge; solve_traced's histograms and per-superstep spans.
"""

import json

import numpy as np
import pytest
import torch

from ksched_tpu.obs import soltel as jt
from ksched_tpu.obs.metrics import scoped_registry as j_scoped
from ksched_tpu.solver import ell_solver as je
from ksched_tpu.solver import jax_solver as js
from ksched_tpu.solver import layered as jl
from ksched_tpu.solver import mega_solver as jm
from ksched_tpu_torch.obs import soltel as tt
from ksched_tpu_torch.obs.exporter import render_prometheus
from ksched_tpu_torch.obs.metrics import scoped_registry as t_scoped
from ksched_tpu_torch.ops import mcmf
from ksched_tpu_torch.solver import csr_solver as cs
from ksched_tpu_torch.solver import ell_solver as te
from ksched_tpu_torch.solver import layered as tl
from ksched_tpu_torch.solver import mega_solver as tm

from test_jax_solver import random_scheduling_problem
from test_torch_csr_solver import _port, _rounds
from test_torch_mega import _jax, _loop_inputs, _plain

#: a ring shorter than most solves here, so that it wraps
CAP = 8


def _problem(tasks, machines, seed):
    return random_scheduling_problem(np.random.default_rng(seed), num_tasks=tasks,
                                     num_machines=machines, slots_per_machine=2)


def _same_tel(got, want):
    """Two decoded rings (or None) equal field for field."""
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()
        assert got.rows.dtype == want.rows.dtype == np.int32


def _event(e):
    return {k: v for k, v in e.items() if k != "ts"}


# ---------------------------------------------------------------------------
# host half: decode, stall detection, failure reasons, price-war events
# ---------------------------------------------------------------------------


def _ring(seed, cap, steps, eps_plateau=False):
    """A numpy ring of `cap` rows after `steps` supersteps: rows past
    `steps` unwritten, a wrapped ring when steps > cap."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((cap, tt.SOLTEL_WIDTH), np.int32)
    eps = np.repeat([64, 8, 1], -(-steps // 3))[:steps]
    if eps_plateau:
        eps[:] = 8
    for s in range(steps):
        row = rng.integers(0, 50, tt.SOLTEL_WIDTH).astype(np.int32)
        row[0], row[7] = eps[s], 0
        row[1] = max(row[1], 1)
        row[2] = steps - s if not eps_plateau else 40 + (s % 3)
        buf[s % cap] = row
    return buf


RINGS = [  # (seed, cap, steps, budget, converged, eps plateau)
    (0, 16, 5, 100, True, False),  # part full
    (1, 16, 16, 100, True, False),  # full
    (2, 8, 21, 100, True, False),  # wrapped
    (3, 64, 95, 100, True, False),  # truncated, near its budget
    (4, 128, 128, 128, False, False),  # the budget spent
    (5, 256, 300, 300, False, True),  # an eps plateau, wrapped
    (6, 64, 64, 500, False, True),  # an excess plateau
    (7, 4, 0, 10, True, False),  # no superstep
]


@pytest.mark.parametrize("case", RINGS, ids=lambda c: f"cap{c[1]}_steps{c[2]}")
def test_decode_and_stall_detection_match_jax(case):
    seed, cap, steps, budget, conv, plateau = case
    buf = _ring(seed, cap, steps, plateau)
    kw = dict(converged=conv, nodes=11, arcs=17)
    want = jt.decode(buf, steps, cap, "jax", budget, **kw)
    got = tt.decode(torch.as_tensor(buf), steps, cap, "jax", budget, **kw)
    _same_tel(got, want)
    assert got.truncated == (steps > cap)
    assert got.phases() == want.phases()
    assert got.tail() == want.tail() and got.tail(3) == want.tail(3)
    for window in (4, 64):
        assert tt.detect_stall(got, window) == jt.detect_stall(want, window)
    with pytest.raises(ValueError):
        tt.decode(buf[:, :3], steps, cap, "jax", budget)


def test_stall_kinds_are_all_reached():
    kinds = set()
    for seed, cap, steps, budget, conv, plateau in RINGS:
        tel = tt.decode(_ring(seed, cap, steps, plateau), steps, cap, "t", budget,
                        converged=conv)
        for window in (4, 64):
            reason = tt.detect_stall(tel, window)
            kinds.add(reason and reason["kind"])
    assert kinds >= {"excess_plateau", "eps_plateau", "superstep_budget_exhausted",
                     "superstep_cap_proximity", None}


@pytest.mark.parametrize("case", RINGS[:6], ids=lambda c: f"cap{c[1]}_steps{c[2]}")
def test_warm_price_war_and_note_stall_match_jax(case):
    seed, cap, steps, budget, _conv, plateau = case
    buf = _ring(seed, cap, steps, plateau)
    events, counts = [], []
    for mod, scoped in ((jt, j_scoped), (tt, t_scoped)):
        mod.reset_stalls()
        with scoped() as reg:
            tel = mod.decode(buf, steps, cap, "jax", budget, converged=False)
            e1 = mod.warm_price_war("jax", steps, budget, tel=tel)
            e2 = mod.warm_price_war("jax", steps, budget, escaped_to="cost_scaling")
            with mod.stall_scope("t1"):
                e3 = mod.note_stall({"kind": "excess_plateau", "excess": 3})
            events.append([_event(e) for e in (e1, e2, e3)])
            events.append([_event(e) for e in mod.recent_stalls()])
            counts.append(reg.value("ksched_solver_stalls_total", kind="warm_price_war"))
        mod.reset_stalls()
    assert events[2:] == events[:2]
    assert counts == [2, 2]


def test_failure_reason_matches_jax():
    from ksched_tpu_torch.solver.base import SolverStallError

    tel_args = (_ring(2, 8, 21), 21, 8, "mega", 21)
    jtel = jt.decode(*tel_args, converged=False)
    ttel = tt.decode(*tel_args, converged=False)
    pairs = [
        (jt.SolverStallError("stuck", jt.detect_stall(jtel), jtel),
         SolverStallError("stuck", tt.detect_stall(ttel), ttel)),
        (RuntimeError("chaos: forced"), RuntimeError("chaos: forced")),
        (ValueError("non-finite"), ValueError("non-finite")),
        (OverflowError("p"), OverflowError("p")),
        (RuntimeError("boom"), RuntimeError("boom")),
    ]
    assert SolverStallError is tt.SolverStallError
    for je_, te_ in pairs:
        assert tt.failure_reason("mega", te_) == jt.failure_reason("mega", je_)


def test_publish_matches_jax():
    """publish(): the registry texts of both packages after the same
    decoded rings (a wrapped one, a plateau) are equal, and so are the
    stall events it notes; publish_round_supersteps likewise."""
    from ksched_tpu.obs.exporter import render_prometheus as j_render

    texts, events = [], []
    for mod, scoped, render in ((jt, j_scoped, j_render), (tt, t_scoped, render_prometheus)):
        mod.reset_stalls()
        with scoped() as reg:
            for seed, cap, steps, budget, conv, plateau in RINGS:
                mod.publish(mod.decode(_ring(seed, cap, steps, plateau), steps, cap,
                                       "ell", budget, converged=conv))
            mod.publish_round_supersteps([3, 5, 9], backend="device/cuda")
            texts.append(render(reg))
        events.append([_event(e) for e in mod.recent_stalls()])
        mod.reset_stalls()
    assert texts[0] == texts[1] and "ksched_solve_telemetry_truncated_total" in texts[0]
    assert events[0] == events[1] and events[0]
    with t_scoped() as reg:
        tt.publish_round_supersteps(torch.tensor([4, 4], dtype=torch.int32), "d")
        assert reg.value("ksched_solve_supersteps", backend="d") == 2


def test_resolve_cap_and_switches():
    prior = tt.enabled()
    try:
        tt.set_enabled(False)
        assert tt.resolve_cap(None) == 0
        s = cs.CsrSolver(device="cpu")
        s.solve(_port(_problem(8, 3, 1)))
        assert s.last_telemetry is None
        tt.set_enabled(True)
        assert tt.resolve_cap(None) == tt.SOLTEL_DEFAULT_CAP
        assert tt.resolve_cap(7) == 7 and tt.resolve_cap(0) == 0
    finally:
        tt.set_enabled(prior)


# ---------------------------------------------------------------------------
# rings, backend by backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kw", [{}, {"restart_budget": 2}], ids=["default", "budget2"])
def test_csr_rings_and_price_wars_match_jax(seed, kw):
    """CsrSolver against JaxSolver over warm-started rounds (argsort
    plan): each round's decoded ring, and with restart_budget=2 the
    warm_price_war events the burnt warm attempts deposit."""
    events = []
    jx = js.JaxSolver(slot_stable=False, telemetry=CAP, **kw)
    port = cs.CsrSolver(device="cpu", telemetry=CAP, **kw)
    wrapped = 0
    for mod in (jt, tt):
        mod.reset_stalls()
    for i, jp in enumerate(_rounds(seed)):
        want = jx.solve(jp)
        got = port.solve(_port(jp))
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        _same_tel(port.last_telemetry, jx.last_telemetry)
        wrapped += port.last_telemetry.truncated
    for mod in (jt, tt):
        events.append([_event(e) for e in mod.recent_stalls()])
        mod.reset_stalls()
    assert events[0] == events[1]
    assert wrapped > 0
    if kw:
        assert any(e["kind"] == "warm_price_war" for e in events[0])


def test_csr_slot_stable_rings_match_jax():
    """The slot-stable plan over the churn scenario at a small size
    (tests/test_torch_csr_slot_stable.py's): every round's ring (9-11
    supersteps in an 8-row ring: it wraps) equal to JaxSolver's."""
    from ksched_tpu_torch.drivers.churn import ChurnArm
    from torch_churn_reference import JaxChurnArm

    kw = dict(tasks=400, machines=40, churn=0.05)
    jarm = JaxChurnArm(**kw, backend=js.JaxSolver(restart_budget=64, telemetry=CAP))
    arm = ChurnArm("device_resident", **kw, device="cpu",
                   backend=cs.CsrSolver(restart_budget=64, telemetry=CAP, device="cpu"))
    _same_tel(arm.solver.last_telemetry, jarm.solver.last_telemetry)
    wrapped = 0
    for r in range(4):
        jarm.drive_round(r)
        arm.drive_round(r)
        wrapped += arm.solver.last_telemetry.truncated
        _same_tel(arm.solver.last_telemetry, jarm.solver.last_telemetry)
    assert wrapped > 0
    assert arm.counters()["price_wars"] == 0


@pytest.mark.parametrize("seed", range(2))
def test_ell_rings_match_jax(seed):
    jx = je.EllSolver(telemetry=CAP)
    port = te.EllSolver(device="cpu", telemetry=CAP)
    for i, jp in enumerate(_rounds(seed)):
        want = jx.solve(jp)
        got = port.solve(_port(jp))
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        _same_tel(port.last_telemetry, jx.last_telemetry)


def _layered_problem(C, M, seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        supply=rng.integers(1, 30, C).astype(np.int32),
        col_cap=rng.integers(0, 3, M).astype(np.int32),
        cost_cm=rng.integers(0, 50, (C, M)).astype(np.int32),
        unsched_cost=40, ec_cost=2,
    )


@pytest.mark.parametrize("cap", [CAP, 512])
@pytest.mark.parametrize("bucket", [(4, 40), (4, 130), (6, 300)], ids=str)
def test_layered_rings_match_jax(bucket, cap):
    """The layered transport's plain loop on the CPU against the JAX
    package's XLA loop on the CPU: the ring of the last attempt."""
    fields = _layered_problem(*bucket)
    jx = jl.LayeredTransportSolver(telemetry=cap)
    port = tl.LayeredTransportSolver(telemetry=cap, device="cpu")
    want = jx.solve_layered(jl.LayeredProblem(**fields))
    got = port.solve_layered(tl.LayeredProblem(**fields))
    np.testing.assert_array_equal(got.y, want.y)
    assert got.supersteps == want.supersteps > 0
    _same_tel(port.last_telemetry, jx.last_telemetry)
    assert port.last_telemetry.backend == "layered"


def test_layered_closed_form_has_no_ring():
    fields = _layered_problem(1, 40)
    port = tl.LayeredTransportSolver(telemetry=CAP, device="cpu")
    assert port.solve_layered(tl.LayeredProblem(**fields)).supersteps == 0
    assert port.last_telemetry is None


MCMF_CASES = [  # (seed, tasks, machines, lanes, eps: "1" or "cold", cap)
    (0, 8, 3, None, "cold", 64),
    (1, 14, 4, None, "1", 512),
    (2, 14, 4, 8, "cold", 64),  # mega_telemetry_cap clamps 64 to R rows
    (3, 22, 5, 64, "cold", 4),  # a 4-row ring that wraps
]


@pytest.mark.parametrize("case", MCMF_CASES, ids=lambda c: f"seed{c[0]}_cap{c[5]}")
def test_mcmf_plain_ring_matches_interpreted_kernel(case):
    """`mcmf_loop_plain` against the JAX package's Pallas kernel run by
    its interpreter, with the ring: every output, the ring's clamped
    length among them, equal."""
    from ksched_tpu.ops.mcmf_pallas import mcmf_loop_pallas, mega_telemetry_cap

    seed, tasks, machines, lanes, eps_kind, cap = case
    p = _problem(tasks, machines, seed)
    arrays, tables, R, L = _loop_inputs(p, lanes)
    eps = 1 if eps_kind == "1" else max(1, int(np.abs(p.cost).max()) * p.num_nodes)
    want = _jax(mcmf_loop_pallas, arrays, tables, R, L, eps, interpret=True,
                telemetry_cap=cap)
    got = _plain(arrays, tables, R, L, eps, telemetry_cap=cap)
    assert len(got) == len(want) == 5
    for name, a, b in zip(("flow", "steps", "converged", "p_overflow", "ring"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    clamped = mcmf.mega_telemetry_cap(R, L, cap)
    assert clamped == mega_telemetry_cap(R, L, cap) == got[4].shape[0]
    if lanes == 8:
        assert clamped < cap
    assert got[4].dtype == np.int32
    off = _plain(arrays, tables, R, L, eps)
    for a, b in zip(got[:4], off):
        np.testing.assert_array_equal(a, b)


def test_mega_standin_ring_matches_interpreted_kernel():
    """The JAX side's stand-in for the kernel (tests/torch_event_mega_
    reference.py), asked for a ring, gives the interpreted kernel's."""
    from ksched_tpu.ops.mcmf_pallas import mcmf_loop_pallas
    from torch_event_mega_reference import mega_standin

    p = _problem(14, 4, 3)
    arrays, tables, R, L = _loop_inputs(p, None)
    eps = max(1, int(np.abs(p.cost).max()) * p.num_nodes)
    for cap in (CAP, 512):
        want = _jax(mcmf_loop_pallas, arrays, tables, R, L, eps, interpret=True,
                    telemetry_cap=cap)
        got = _jax(mega_standin, arrays, tables, R, L, eps, telemetry_cap=cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert int(got[1]) > CAP


def test_mega_solver_rings_match_jax():
    """MegaSolver (plain B3) against the JAX MegaSolver (interpreted
    kernel) over warm rounds, and the CSR ring of the same solve: the
    two algorithms agree superstep for superstep."""
    jx = jm.MegaSolver(interpret=True, telemetry=64)
    port = tm.MegaSolver(device="cpu", telemetry=64)
    csr = cs.CsrSolver(device="cpu", telemetry=64, journal_scoped_warm=False,
                       warm_potentials=False)
    for i, jp in enumerate(_rounds(3)[:3]):
        want = jx.solve(jp)
        got = port.solve(_port(jp))
        csr.solve(_port(jp))
        np.testing.assert_array_equal(got.flow, want.flow, err_msg=f"round {i}")
        _same_tel(port.last_telemetry, jx.last_telemetry)
        k = min(len(port.last_telemetry.rows), len(csr.last_telemetry.rows))
        np.testing.assert_array_equal(port.last_telemetry.rows[-k:],
                                      csr.last_telemetry.rows[-k:])


def test_mega_fallback_telemetry_is_the_fallbacks():
    p = _port(_problem(8, 3, 2))
    mg = tm.MegaSolver(device="cpu", budget_bytes=64, telemetry=CAP,
                       fallback=cs.CsrSolver(device="cpu", telemetry=CAP))
    mg.solve(p)
    assert mg.last_telemetry is mg.fallback.last_telemetry is not None
    assert mg.last_telemetry.backend == "jax"


# ---------------------------------------------------------------------------
# flows with the ring on and off; stalls; solve_traced
# ---------------------------------------------------------------------------


def _port_backends():
    return {
        "jax": lambda tel: cs.CsrSolver(device="cpu", telemetry=tel),
        "ell": lambda tel: te.EllSolver(device="cpu", telemetry=tel),
        "mega": lambda tel: tm.MegaSolver(device="cpu", telemetry=tel),
    }


@pytest.mark.parametrize("backend", ["jax", "ell", "mega"])
@pytest.mark.parametrize("bucket", [(8, 3), (14, 4), (22, 5)], ids=str)
def test_flows_bit_identical_on_off(backend, bucket):
    make = _port_backends()[backend]
    p = _port(_problem(*bucket, seed=7))
    off, on = make(0), make(CAP)
    r_off, r_on = off.solve(p), on.solve(p)
    np.testing.assert_array_equal(r_on.flow, r_off.flow)
    assert (r_on.objective, r_on.iterations) == (r_off.objective, r_off.iterations)
    assert off.last_telemetry is None
    tel = on.last_telemetry
    assert tel.backend == backend and tel.steps == on.last_supersteps
    assert (tel.rows[:, 3] + tel.rows[:, 4]).max() > 0


@pytest.mark.parametrize("bucket", [(4, 40), (6, 300)], ids=str)
def test_layered_flows_bit_identical_on_off(bucket):
    fields = _layered_problem(*bucket)
    off = tl.LayeredTransportSolver(telemetry=0, device="cpu")
    on = tl.LayeredTransportSolver(telemetry=CAP, device="cpu")
    r_off = off.solve_layered(tl.LayeredProblem(**fields))
    r_on = on.solve_layered(tl.LayeredProblem(**fields))
    np.testing.assert_array_equal(r_on.y, r_off.y)
    assert (r_on.objective, r_on.supersteps) == (r_off.objective, r_off.supersteps)
    assert off.last_telemetry is None and on.last_telemetry.steps == r_on.supersteps


def _stall_pairs():
    return {
        "jax": (lambda: js.JaxSolver(max_supersteps=3, telemetry=64),
                lambda: cs.CsrSolver(max_supersteps=3, telemetry=64, device="cpu")),
        "ell": (lambda: je.EllSolver(max_supersteps=3, telemetry=64),
                lambda: te.EllSolver(max_supersteps=3, telemetry=64, device="cpu")),
        "mega": (lambda: jm.MegaSolver(max_supersteps=3, telemetry=64, interpret=True),
                 lambda: tm.MegaSolver(max_supersteps=3, telemetry=64, device="cpu")),
    }


@pytest.mark.parametrize("backend", ["jax", "ell", "mega"])
def test_stall_reason_and_tail_match_jax(backend):
    make_j, make_t = _stall_pairs()[backend]
    p = _problem(22, 5, seed=5)
    with pytest.raises(jt.SolverStallError) as jerr:
        make_j().solve(p)
    with pytest.raises(tt.SolverStallError) as terr:
        make_t().solve(_port(p))
    assert isinstance(terr.value, RuntimeError)
    assert terr.value.reason == jerr.value.reason is not None
    assert terr.value.reason["kind"] in (
        "superstep_budget_exhausted", "excess_plateau", "eps_plateau")
    _same_tel(terr.value.telemetry, jerr.value.telemetry)
    assert terr.value.telemetry.tail() == jerr.value.telemetry.tail()
    assert str(terr.value) == str(jerr.value)


def test_layered_stall_matches_jax():
    fields = _layered_problem(6, 300)
    jx = jl.LayeredTransportSolver(max_supersteps=5, telemetry=64)
    port = tl.LayeredTransportSolver(max_supersteps=5, telemetry=64, device="cpu")
    with pytest.raises(jt.SolverStallError) as jerr:
        jx.solve_layered(jl.LayeredProblem(**fields))
    with pytest.raises(tt.SolverStallError) as terr:
        port.solve_layered(tl.LayeredProblem(**fields))
    assert terr.value.reason == jerr.value.reason
    _same_tel(port.last_telemetry, jx.last_telemetry)


def _trace(events):
    """Span events without times or ids: (name, args) in order."""
    drop = {"sid", "parent_sid"}
    return [(e["name"], {k: v for k, v in e.get("args", {}).items() if k not in drop})
            for e in events]


def test_solve_traced_publishes_like_jax():
    """solve_traced: the same registry text (superstep histograms,
    per-phase histograms, pushes, relabels, truncations) and the same
    per-superstep child spans under backend_solve, in both packages."""
    from ksched_tpu.obs.exporter import render_prometheus as j_render
    from ksched_tpu.obs.spans import SpanTracer as JTracer
    from ksched_tpu_torch.obs.spans import SpanTracer as TTracer

    out = []
    for solver, scoped, tracer_cls, render, prep, mod in (
        (js.JaxSolver(telemetry=CAP), j_scoped, JTracer, j_render, lambda p: p, jt),
        (cs.CsrSolver(telemetry=CAP, device="cpu"), t_scoped, TTracer,
         render_prometheus, _port, tt),
    ):
        mod.reset_stalls()
        tracer = tracer_cls()
        with scoped() as reg:
            with tracer:
                for jp in _rounds(1)[:3]:
                    solver.solve_traced(prep(jp))
            text = render(reg)
        spans = _trace(tracer.events())
        for name, args in spans:
            if name == "backend_solve":
                args.pop("backend")  # JaxSolver / CsrSolver
        out.append((text, spans))
        mod.reset_stalls()
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    names = [n for n, _ in out[1][1]]
    assert names.count("backend_solve") == 3 and "superstep" in names
    assert json.dumps(out[1][1])  # JSON-able args
