"""portbench/spans.py: the readers of the program's spans and counters on
synthetic contexts, a run of each cell at a small size on the CPU with
the tracer installed, the benchmark's own runs executing no tracer
code, and on the card the capture's reduction with and without the
program's ranges."""

import time

import numpy as np
import pytest

from portbench import harness, spans
from portbench.tests.small import GTRACE, QUINCY, REPLAY, STEADY


def _ev(name, ts, dur, sid, parent=None, **args):
    a = dict(args, sid=sid)
    if parent is not None:
        a["parent_sid"] = parent
    return {"name": name, "ts": ts, "dur": dur, "args": a}


#: two rounds (10 ms, 20 ms) with 4 + 1 ms of reads, an upkeep of two
#: table spans between them, and one orphaned read outside any round
SPANS = [
    _ev("round", 0, 10_000, 1, path="steady"),
    _ev("solve", 1_000, 8_000, 2, 1),
    _ev("read", 1_500, 3_000, 3, 2, kind="branch"),
    _ev("read", 6_000, 1_000, 4, 2, kind="flag"),
    _ev("fetch_state", 11_000, 2_000, 5),
    _ev("group_table", 13_500, 1_000, 6, op="evict_idle"),
    _ev("group_table", 14_600, 400, 7, op="sync"),
    _ev("round", 20_000, 20_000, 8, path="steady"),
    _ev("read", 21_000, 1_000, 9, 8, kind="flag"),
    _ev("group_table", 21_500, 300, 10, 8, op="groups_for"),
]
SETUP = [_ev("stage", 0, 5e6, 11), _ev("stage.windows", 0, 3.5e6, 12, 11),
         _ev("stage.pack", 3.5e6, 1.5e6, 13, 11)]


def _ctx(**over):
    ctx = {"spans": SPANS, "setup_spans": SETUP,
           "counters": {("ksched_device_discarded_supersteps_total", (("site", "stage1"),)): 512.0,
                        ("ksched_device_discarded_supersteps_total", (("site", "eps0"),)): 128.0,
                        ("ksched_solves_total", ()): 7.0},
           "counts": {"supersteps": np.array([1000, 600, 0], np.int64)},
           "idle_by_span": {"idle_s": 4.0, "in_round_s": 1.0, "by_span": {}, "launches": {}}}
    ctx.update(over)
    return ctx


def test_readers_on_a_synthetic_ctx():
    got = {name: fn(_ctx()) for name, (fn, _u, _m) in spans.READERS.items()}
    assert got == pytest.approx({
        "round_issue_ms": ((10 - 4) + (20 - 1)) / 2,
        "read_wait_ms": (4 + 1) / 2,
        "idle_in_round_pct": 25.0,
        "wasted_supersteps_pct": 100 * 640 / 1600,
        "group_table_sync_ms": 3.4,  # the top-level upkeep spans alone
        "stage_windows_s": 3.5,
    })


@pytest.mark.parametrize("name", list(spans.READERS))
def test_readers_read_none_where_nothing_is(name):
    fn = spans.READERS[name][0]
    # a ring that dropped events hands its readers None
    dropped = _ctx(spans=None, setup_spans=None)
    empty = {"spans": [], "setup_spans": [], "counters": None, "counts": None,
             "idle_by_span": None}
    if name in ("idle_in_round_pct", "wasted_supersteps_pct"):
        assert fn(dropped) is not None
    else:
        assert fn(dropped) is None
    assert fn(empty) is None
    assert fn({}) is None


def test_self_time_a_round():
    got = spans.self_ms_per_round(SPANS)
    assert got["read"] == pytest.approx((3 + 1 + 1) / 2)
    assert got["solve"] == pytest.approx((8 - 4) / 2)
    assert got["round"] == pytest.approx(((10 - 8) + (20 - 1 - 0.3)) / 2)


def test_rounds_by_path():
    ev = SPANS + [_ev("attempt", 1_600, 2_000, 20, 2, site="stage1", budget=2048, rows=512),
                  _ev("attempt", 3_700, 2_000, 21, 2, site="full", budget=14336, rows=512)]
    got = spans.rounds_by_path(ev)
    assert got == {"512:stage1+full": {"rounds": 1, "round_ms": 10.0, "read_ms": 4.0,
                                       "above_p95": 0},
                   "closed form": {"rounds": 1, "round_ms": 20.0, "read_ms": 1.0,
                                   "above_p95": 1}}


def test_capture_intervals():
    assert spans._complement(spans._union([(5, 8), (1, 3), (2, 4)]), 0, 10) == [
        (0, 1), (4, 5), (8, 10)]
    segs = spans._innermost([(0, 10, "round"), (2, 6, "solve"), (3, 4, "read")])
    assert segs == [(0, 2, "round"), (2, 3, "solve"), (3, 4, "read"), (4, 6, "solve"),
                    (6, 10, "round")]
    assert spans._overlap([(1e9, 4e9)], [(0, 2e9, "a"), (3e9, 5e9, "b")]) == {
        "a": 1.0, "b": 1.0}


@pytest.mark.parametrize("cell,cfg,mix,own", [
    ("quincy10k-multiblock.steady", QUINCY, dict(STEADY, upkeep_every=2),
     "group_table_sync_ms"),
    ("gtrace12k-coco.replay", GTRACE, REPLAY, "stage_windows_s"),
], ids=["quincy", "replay"])
def test_a_traced_run_reads_every_reader(cell, cfg, mix, own):
    line, ctx, capture = spans.run(cell, 2**31 + 5, 1.0, profile=True, device="cpu",
                                   cfg=cfg, mix=mix)
    assert line["correct"] is True and ctx["dropped"] == 0
    rec = spans.report(cell, 2**31 + 5, line, ctx, capture)
    others = {"group_table_sync_ms", "stage_windows_s"} - {own}
    for name, value in rec["readers"].items():
        assert (value is None) == (name in others), name
    assert rec["self_ms_per_round"]["b1"] > 0
    assert sum(g["rounds"] for g in rec["rounds_by_path"].values()) == len(
        ctx["counts"]["supersteps"])
    assert any(k.startswith("ksched_device_solve_attempts_total") for k in rec["counters"])
    assert rec["idle_by_span"]["idle_s"] > 0  # no card: the window is idle
    # no card, no kernel: the reduction is unmoved by the ranges
    assert rec["ranges_check"] == {"launches": [0, 0], "busy_s": [0.0, 0.0]}


def test_the_benchmarks_own_runs_execute_no_tracer_code(monkeypatch):
    from ksched_tpu_torch.obs import spans as program_spans

    calls = []
    monkeypatch.setattr(program_spans, "_profiler_hooks", lambda: calls.append("hooks"))
    for name in ("_open_range", "_append", "install"):
        monkeypatch.setattr(program_spans.SpanTracer, name,
                            lambda self, *a, _n=name: calls.append(_n))
    bench = harness.load_benchmark()
    for trace in (False, True):
        line, _f = harness.run_cell(bench, "quincy10k-multiblock.steady", QUINCY, STEADY,
                                    2**31 + 7, 0.5, trace, "cpu", time.perf_counter())
        assert line["correct"] is True
    assert calls == [] and program_spans.active_tracer() is None


@pytest.mark.cuda
def test_the_program_ranges_leave_the_reduction_unmoved_on_the_card():
    """A traced quincy window with the program's ranges in the capture:
    `portbench/trace.py` reduces it to the same launches and busy
    seconds as the same capture with the ranges taken out."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, ctx, capture = spans.run("quincy10k-multiblock.steady", 2**31 + 13, 3.0)
    rec = spans.report("quincy10k-multiblock.steady", 2**31 + 13, line, ctx, capture)
    assert line["correct"] is True and ctx["dropped"] == 0
    got = rec["ranges_check"]
    assert got["launches"][0] == got["launches"][1]
    assert got["busy_s"][0] == pytest.approx(got["busy_s"][1], rel=1e-9)
