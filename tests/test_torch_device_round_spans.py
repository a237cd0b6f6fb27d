"""The device round's spans and solve counters (obs/spans.py,
obs/devprof.py DeviceSolveCounters) on the CPU: the span tree of a
grouped steady round through the two-stage path and through the
fallback, and of a replay window; the self-time arithmetic; the
discarded attempts' supersteps against the device's own count; a round
with no tracer installed recording nothing and calling nothing of the
profiler, with placements and stats equal to a traced round's; the
spans as ranges of a CPU torch.profiler capture on its clock; the
Chrome export's clock offset."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ksched_tpu_torch.ops as kops
from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu_torch.drivers import trace_replay as tt
from ksched_tpu_torch.obs import spans
from ksched_tpu_torch.obs.devprof import DeviceSolveCounters
from ksched_tpu_torch.obs.metrics import Registry, scoped_registry
from ksched_tpu_torch.obs.spans import SpanTracer, self_times
from ksched_tpu_torch.scheduler.device_bulk import PREF_NONE, DeviceBulkCluster, draw_steady
from ksched_tpu_torch.solver.layered import transport_fori

M, G, TCAP = 64, 24, 512
#: the phases directly under a round, in order
PHASES = ["intake", "census", "costs", "solve", "decode"]


def _grouped(reg):
    """A grouped cluster (tests/test_torch_quincy_device.py's steady
    shape) whose first steady round takes the fallback (stage 1 spends
    its 256 supersteps) and whose second takes the two-stage path."""
    rng = np.random.default_rng(42)
    with scoped_registry(reg):
        c = DeviceBulkCluster(num_machines=M, pus_per_machine=2, slots_per_pu=2, num_jobs=1,
                              num_task_classes=1, task_capacity=TCAP, num_groups=G,
                              decode_width=256, supersteps=1 << 15, device="cpu")
    pref = np.full((G, M), PREF_NONE, np.int64)
    for g in range(G):
        pref[g, rng.choice(M, 2, replace=False)] = 0
    c.set_groups(cls=np.zeros(G), job=np.zeros(G), e=np.full(G, 512), u=np.full(G, 513),
                 pref_w=pref)
    c.add_tasks(200, groups=rng.integers(0, G, 200).astype(np.int32))
    return c


def _draws(n):
    gen = torch.Generator().manual_seed(3)
    return [draw_steady(gen, TCAP, G, 1) for _ in range(n)]


def _launches(monkeypatch):
    """Each B1 launch's (budget, device steps), recorded."""
    got = []
    plain = kops.transport_solve

    def recorded(*args, **kw):
        out = plain(*args, **kw)
        got.append((kw["max_supersteps"], int(out[2])))
        return out

    monkeypatch.setattr(kops, "transport_solve", recorded)
    return got


def _tree(events):
    """[(depth, name, args without ids)] in start order, depth by the
    parent ids alone."""
    by_sid = {e["args"]["sid"]: e for e in events}

    def depth(e):
        d = 0
        while "parent_sid" in e["args"]:
            e = by_sid[e["args"]["parent_sid"]]
            d += 1
        return d

    return [(depth(e), e["name"],
             {k: v for k, v in e["args"].items() if k not in ("sid", "parent_sid", "parent")})
            for e in sorted(events, key=lambda e: (e["ts"], -e["dur"]))]


def _discarded(reg, site):
    return reg.value("ksched_device_discarded_supersteps_total", site=site)


@pytest.fixture(scope="module")
def grouped_rounds():
    """Two grouped steady rounds under a tracer: (per round its events,
    B1 launches, stats, grouped path and attempt counts; the registry)."""
    reg = Registry()
    c = _grouped(reg)
    tr = SpanTracer().install()
    mp = pytest.MonkeyPatch()
    rounds = []
    try:
        launches = _launches(mp)
        for d in _draws(2):
            mark, first = tr.mark(), len(launches)
            stats = c.fetch_stats(c.steady_round(*d, 0.05, 10))
            rounds.append((tr.events_since(mark), launches[first:], stats,
                           c.last_grouped_path, dict(_counts(reg))))
    finally:
        tr.uninstall()
        mp.undo()
    return rounds, reg


def _counts(reg):
    for site in ("stage1", "full", "eps0", "retry"):
        for outcome in ("kept", "discarded"):
            yield (site, outcome), reg.value("ksched_device_solve_attempts_total",
                                             site=site, outcome=outcome)
        yield (site, "steps"), _discarded(reg, site)


def test_fallback_round_tree_and_discarded_stage1(grouped_rounds):
    events, launches, stats, path, counts = grouped_rounds[0][0]
    assert path == (G, "fallback")
    tree = _tree(events)
    assert tree[0] == (0, "round", {"path": "steady"})
    assert [n for d, n, _a in tree if d == 1] == PHASES
    solve = [(d, n, a) for d, n, a in tree if d >= 2]
    assert solve == [
        (2, "read", {"kind": "branch"}),
        (2, "attempt", {"site": "stage1", "budget": 256, "rows": G}),
        (3, "b1", {"C": G, "Mp": 128}),
        (2, "read", {"kind": "flag"}),
        (2, "attempt", {"site": "full", "budget": (1 << 15) - 256, "rows": G}),
        (3, "b1", {"C": G, "Mp": 128}),
        (2, "read", {"kind": "flag"}),
    ]
    # stage 1 ran its whole budget on the device, and that is what the
    # host counted without a read
    assert launches[0] == (256, 256)
    assert counts[("stage1", "steps")] == launches[0][1] == 256
    assert counts[("stage1", "discarded")] == 1 and counts[("full", "kept")] == 1
    assert int(stats["supersteps"]) == sum(s for _b, s in launches)
    assert bool(stats["converged"])


def test_two_stage_round_tree(grouped_rounds):
    events, launches, stats, path, counts = grouped_rounds[0][1]
    assert path == (G, "two-stage")
    tree = _tree(events)
    assert [n for d, n, _a in tree if d == 1] == PHASES
    assert [(d, n) for d, n, _a in tree if d >= 2] == [
        (2, "read"), (2, "attempt"), (3, "b1"), (2, "read")]
    assert len(launches) == 1 and launches[0][1] < 256
    assert counts[("stage1", "kept")] == 1 and counts[("stage1", "discarded")] == 1
    assert counts[("stage1", "steps")] == 256  # nothing more discarded


def test_grouped_solves_counted_by_rows_and_path(grouped_rounds):
    reg = grouped_rounds[1]
    assert reg.value("ksched_grouped_solves_total", rows=str(G), path="fallback") == 1
    assert reg.value("ksched_grouped_solves_total", rows=str(G), path="two-stage") == 1
    assert reg.value("ksched_grouped_solves_total", rows=str(G), path="full") == 0


def test_eps0_retry_discards_its_first_attempt(monkeypatch):
    """A short-start attempt that spends its budget is retried from the
    full range; the counter holds the first launch's device steps."""
    rng = np.random.default_rng(1)
    C, Mp = 4, 17
    wS = torch.as_tensor(rng.integers(-400, 400, (C, Mp)).astype(np.int32))
    wS[:, -1] = 0
    supply = torch.tensor([9, 7, 5, 8], dtype=torch.int32)
    col_cap = torch.full((Mp,), 3, dtype=torch.int32)
    col_cap[-1] = int(supply.sum())
    reg = Registry()
    log = DeviceSolveCounters(reg)
    launches = _launches(monkeypatch)
    y, _pm, steps, conv, known = transport_fori(wS, supply, col_cap, 5000, alpha=2,
                                                eps0=1, eps0_budget=3, log=log)
    log.settle()
    assert known is None and bool(conv)
    assert [b for b, _s in launches] == [3, 5000]
    assert launches[0][1] == 3  # the discarded attempt ran its budget
    assert _discarded(reg, "eps0") == launches[0][1]
    assert reg.value("ksched_device_solve_attempts_total", site="eps0", outcome="discarded") == 1
    assert reg.value("ksched_device_solve_attempts_total", site="retry", outcome="kept") == 1
    assert int(steps) == sum(s for _b, s in launches)


def test_escalated_incremental_attempts_are_discarded(monkeypatch):
    """Three-tier preemption with a 2-superstep incremental budget: each
    escalated round discards its incremental core's two attempts (the
    short start and its retry), and the counters hold exactly the device
    steps of every launch that did not converge."""
    pen = np.random.default_rng(7).integers(0, 40, (12, 4)).astype(np.int64)
    reg = Registry()
    with scoped_registry(reg):
        c = DeviceBulkCluster(num_machines=12, pus_per_machine=2, slots_per_pu=2, num_jobs=2,
                              num_task_classes=4, task_capacity=128,
                              class_cost_fn=coco_device_cost_fn(pen), unsched_cost=8,
                              supersteps=1 << 14, decode_width=32, preemption=True,
                              continuation_discount=1, preempt_every=4,
                              preempt_global_every=8, preempt_incr_budget=2, device="cpu")
    c.add_tasks(60, job_ids=np.arange(60) % 2, classes=np.arange(60) % 4)
    c.round()
    launches = []
    for name in ("transport_solve", "transport_solve_tiered"):
        plain = getattr(kops, name)

        def recorded(*args, _plain=plain, **kw):
            out = _plain(*args, **kw)
            launches.append((kw["max_supersteps"], int(out[2]), bool(out[3])))
            return out

        monkeypatch.setattr(kops, name, recorded)
    before = sum(_discarded(reg, s) for s in ("eps0", "retry"))
    st = c.fetch_stats(c.run_steady_rounds(8, 0.2, 6, seed=4))
    escalated = int(st["escalated_round"].sum())
    assert escalated >= 3
    lost = [(b, s) for b, s, conv in launches if not conv]
    assert len(lost) == 2 * escalated and all(b == s == 2 for b, s in lost)
    assert sum(_discarded(reg, s) for s in ("eps0", "retry")) - before == sum(
        s for _b, s in lost)
    assert reg.value("ksched_device_solve_attempts_total", site="retry",
                     outcome="discarded") == escalated


def test_replay_window_tree():
    machines, tasks = tt.synthesize_trace(num_machines=12, num_tasks=120, duration_s=120.0,
                                          mean_runtime_s=30.0, seed=9, machine_churn=0.5)
    pen = np.random.default_rng(7).integers(0, 40, (12, 4)).astype(np.int64)
    d = tt.DeviceTraceReplayDriver(machines, slots_per_machine=2, num_jobs_hint=8,
                                   task_capacity=256, decode_width=16,
                                   class_cost_fn=coco_device_cost_fn(pen), unsched_cost=8,
                                   supersteps=1 << 14, device="cpu")
    with SpanTracer() as tr:
        sch = d.stage(tasks, window_s=10.0)
        staged = tr.mark()
        d.replay({k: (v[:3] if isinstance(v, np.ndarray) else v) for k, v in sch.items()},
                 seed=5)
    events = tr.events()
    stage = _tree(events[:staged])
    assert stage == [(0, "stage", {}), (1, "stage.windows", {}), (1, "stage.pack", {})]
    tree = _tree(events[staged:])
    assert [n for dp, n, a in tree if dp == 0] == ["round"] * 3
    assert all(a == {"path": "replay"} for dp, n, a in tree if dp == 0)
    assert [n for dp, n, _a in tree if dp == 1] == PHASES * 3
    below = {(dp, n) for dp, n, _a in tree if dp >= 2}
    assert below <= {(2, "read"), (2, "attempt"), (3, "b1")}
    assert (3, "b1") in below


def test_self_times():
    ev = [
        {"name": "round", "dur": 10.0, "args": {"sid": 1}},
        {"name": "solve", "dur": 6.0, "args": {"sid": 2, "parent_sid": 1}},
        {"name": "read", "dur": 1.5, "args": {"sid": 3, "parent_sid": 2}},
        {"name": "attempt", "dur": 4.0, "args": {"sid": 4, "parent_sid": 2}},
        {"name": "b1", "dur": 3.5, "args": {"sid": 5, "parent_sid": 4}},
        {"name": "round", "dur": 2.0, "args": {"sid": 6}},
        # a child whose parent the slice left out counts whole
        {"name": "read", "dur": 0.5, "args": {"sid": 7, "parent_sid": 99}},
    ]
    got = self_times(ev)
    assert got == {"round": 6.0, "solve": 0.5, "read": 2.0, "attempt": 0.5, "b1": 3.5}
    assert sum(got.values()) == 12.5  # the two roots and the orphan


def test_no_tracer_records_nothing_and_calls_no_profiler(monkeypatch):
    """Untraced rounds: no span recorded, no profiler hook looked up or
    range opened; placements and stats equal those of traced rounds on
    the same inputs."""
    calls = []
    monkeypatch.setattr(spans, "_profiler_hooks", lambda: calls.append("hooks"))
    monkeypatch.setattr(SpanTracer, "_open_range", lambda self, n: calls.append(n))
    monkeypatch.setattr(SpanTracer, "_append", lambda self, *a: calls.append("append"))
    draws = _draws(2)
    plain = _grouped(Registry())
    assert spans.active_tracer() is None
    got = [plain.fetch_stats(plain.steady_round(*d, 0.05, 10)) for d in draws]
    assert calls == []
    monkeypatch.undo()
    traced = _grouped(Registry())
    with SpanTracer() as tr:
        want = [traced.fetch_stats(traced.steady_round(*d, 0.05, 10)) for d in draws]
    assert tr.total > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in plain.fetch_state().items():
        np.testing.assert_array_equal(v, traced.fetch_state()[k], err_msg=k)


def test_spans_are_ranges_of_a_cpu_capture_on_its_clock():
    c = _grouped(Registry())
    (d,) = _draws(1)
    with SpanTracer() as tr:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            c.steady_round(*d, 0.05, 10)
    ours = tr.events()
    names = {e["name"] for e in ours}
    assert names >= {"round", "intake", "census", "costs", "solve", "read", "attempt",
                     "b1", "decode"}
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() in names]
    assert sorted(e.name() for e in ranges) == sorted(e["name"] for e in ours)
    rnd = next(e for e in ranges if e.name() == "round")
    mine = next(e for e in ours if e["name"] == "round")
    at = mine["ts"] * 1e3 + tr.epoch_offset_ns  # the span's start on the epoch clock
    assert abs(rnd.start_ns() - at) < 1e6


def test_chrome_export_records_the_clock_offset():
    p0, wall, p1 = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
    tr = SpanTracer().install()
    tr.uninstall()
    q0, wall2, q1 = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
    got = tr.chrome_trace()["otherData"]["epoch_offset_ns"]
    assert got == tr.epoch_offset_ns
    for a, w, b in ((p0, wall, p1), (q0, wall2, q1)):
        assert abs(got - (w - (a + b) // 2)) < 1e6
