"""The port's trace replay (ksched_tpu_torch drivers/trace_replay.py and
DeviceBulkCluster.run_replay_rounds) on the CPU against the JAX
package's, bit for bit: the synthesized streams, the windowing and its
net-effect automaton, the staged schedules, and the replayed windows'
stats and cluster state under both trace policies (per-job closed form,
CoCo census pricing), with machine churn, bursts, the edge cases of
tests/test_device_replay.py, and chunked replays with their own seeds."""

import dataclasses

import numpy as np
import pytest
import torch

from ksched_tpu.costmodels.device_costs import coco_device_cost_fn as jax_coco
from ksched_tpu.drivers import trace_replay as jt
from ksched_tpu_torch.costmodels import coco
from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu_torch.drivers import trace_replay as tt
from ksched_tpu_torch.drivers.gtrace import window_slice

US = int(1e6)
PEN = np.random.default_rng(7).integers(0, 40, (12, 4)).astype(np.int64)

#: synthesize_trace arguments: the small trace of tests/test_device_replay.py,
#: with machine churn, with bursts and correlated outages, and short tasks
TRACES = {
    "plain": dict(num_machines=12, num_tasks=120, duration_s=120.0,
                  mean_runtime_s=30.0, seed=3),
    "churn": dict(num_machines=12, num_tasks=120, duration_s=120.0,
                  mean_runtime_s=30.0, seed=9, machine_churn=0.5),
    "burst": dict(num_machines=12, num_tasks=160, duration_s=120.0,
                  mean_runtime_s=20.0, seed=11, machine_churn=0.25,
                  burst_spike=6.0, burst_count=3, burst_s=4.0,
                  correlated_outages=2, outage_block=4),
    "short": dict(num_machines=6, num_tasks=80, duration_s=120.0,
                  mean_runtime_s=2.0, seed=7),
}


def _tuples(events):
    return [dataclasses.astuple(e) for e in events]


def _both_traces(name):
    a = jt.synthesize_trace(**TRACES[name])
    b = tt.synthesize_trace(**TRACES[name])
    return a, b


def _drivers(machines_j, machines_t, coco_policy=False, **kw):
    """(JAX driver, port driver on the CPU) of one configuration."""
    if coco_policy:
        kw.update(unsched_cost=coco.UNSCHEDULED_COST, supersteps=1 << 14)
        return (jt.DeviceTraceReplayDriver(machines_j, class_cost_fn=jax_coco(PEN), **kw),
                tt.DeviceTraceReplayDriver(machines_t, class_cost_fn=coco_device_cost_fn(PEN),
                                           device="cpu", **kw))
    return (jt.DeviceTraceReplayDriver(machines_j, **kw),
            tt.DeviceTraceReplayDriver(machines_t, device="cpu", **kw))


def _assert_same_schedule(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(y, x, err_msg=k)


def _assert_same_replay(jd, td, want, got):
    """Stats (keys, dtypes, values) and the whole cluster state equal."""
    want = jd.cluster.fetch_stats(want)
    got = td.cluster.fetch_stats(got)
    assert set(want) == set(got)
    for k in want:
        a = np.asarray(want[k])
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    js, ts = jd.cluster.fetch_state(), td.cluster.fetch_state()
    for k in js:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)
    return got


@pytest.mark.parametrize("name", list(TRACES))
def test_streams_windows_and_net_ops_identical(name):
    """synthesize_trace's streams, iter_windows' windows (with the
    machine-event callbacks in order) and window_net_ops' net effects,
    replayed against a live set, are the JAX package's."""
    (mj, ej), (mt, et) = _both_traces(name)
    assert _tuples(mt) == _tuples(mj) and _tuples(et) == _tuples(ej)
    for window_s, max_rounds in ((1.0, None), (10.0, 5)):
        calls_j, calls_t = [], []
        wj = list(jt.iter_windows(ej, window_s, calls_j.append, max_rounds))
        wt = list(tt.iter_windows(et, window_s, calls_t.append, max_rounds))
        assert calls_t == calls_j and [_tuples(w) for w in wt] == [_tuples(w) for w in wj]
        live = set()
        for w_j, w_t in zip(wj, wt):
            rj = jt.window_net_ops(w_j, live.__contains__)
            rt = tt.window_net_ops(w_t, live.__contains__)
            assert rt[0] == rj[0]
            assert [_tuples(x) for x in rt[1:]] == [_tuples(x) for x in rj[1:]]
            live.difference_update(rj[0])
            live.update((e.job_id, e.task_index) for e in rj[1])


@pytest.mark.parametrize("name", list(TRACES))
def test_stage_identical(name):
    """stage(): the host mirror's rows, the fixed-width arrays and the
    staging counts equal the JAX package's."""
    (mj, ej), (mt, et) = _both_traces(name)
    jd, td = _drivers(mj, mt, slots_per_machine=2, num_jobs_hint=8,
                      task_capacity=64, decode_width=None)
    _assert_same_schedule(jd.stage(ej, window_s=10.0), td.stage(et, window_s=10.0))


@pytest.mark.parametrize("policy", ["closed-form", "coco"])
@pytest.mark.parametrize("name", ["plain", "churn", "burst"])
def test_replay_matches_jax(policy, name):
    """The whole staged trace replayed in one call: every window's stats
    and the final state equal; the CoCo policy runs the iterative solve
    on every window."""
    (mj, ej), (mt, et) = _both_traces(name)
    jd, td = _drivers(mj, mt, coco_policy=policy == "coco", slots_per_machine=2,
                      num_jobs_hint=8, task_capacity=256, decode_width=16)
    sch, tsch = jd.stage(ej, window_s=10.0), td.stage(et, window_s=10.0)
    got = _assert_same_replay(jd, td, jd.replay(sch, seed=5), td.replay(tsch, seed=5))
    assert got["converged"].all()
    if policy == "coco":
        assert not td.cluster.row_constant and got["supersteps"].max() > 0
    else:
        assert td.cluster.row_constant and got["supersteps"].max() == 0
    if name != "plain":
        assert got["evicted"].sum() > 0


def test_two_chunks_with_their_own_seeds_and_lengths():
    """Two consecutive run_replay_rounds calls with different seeds and
    window counts: each call's keys and the carry between the calls."""
    (mj, ej), (mt, et) = _both_traces("churn")
    jd, td = _drivers(mj, mt, coco_policy=True, slots_per_machine=2, num_jobs_hint=8,
                      task_capacity=256, decode_width=8)
    sch, tsch = jd.stage(ej, window_s=5.0), td.stage(et, window_s=5.0)
    first = 7
    for i0, k, seed in ((0, first, 3), (first, sch["rounds"] - first, 11)):
        _assert_same_replay(jd, td, jd.replay(window_slice(sch, i0, k), seed=seed),
                            td.replay(window_slice(tsch, i0, k), seed=seed))


# tests/test_device_replay.py's edge cases, as event lists
EDGE_CASES = {
    "duplicate-submit": [
        tt.TraceTaskEvent(0, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(6 * US, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(12 * US, 1, 0, tt.FAIL),
        tt.TraceTaskEvent(13 * US, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(18 * US, 1, 0, tt.FINISH),
    ],
    "fail-resubmit-finish": [
        tt.TraceTaskEvent(0, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(6 * US, 1, 0, tt.FAIL),
        tt.TraceTaskEvent(7 * US, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(9 * US, 1, 0, tt.FINISH),
    ],
    "dup-then-finish": [
        tt.TraceTaskEvent(0, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(6 * US, 1, 0, tt.SUBMIT),
        tt.TraceTaskEvent(7 * US, 1, 0, tt.FINISH),
    ],
    "submit-fail-resubmit": [
        tt.TraceTaskEvent(0, 2, 0, tt.SUBMIT),
        tt.TraceTaskEvent(1 * US, 2, 0, tt.FAIL),
        tt.TraceTaskEvent(2 * US, 2, 0, tt.SUBMIT),
        tt.TraceTaskEvent(9 * US, 2, 0, tt.FINISH),
    ],
}
EDGE_COUNTS = {"duplicate-submit": 2, "fail-resubmit-finish": 2, "dup-then-finish": 1,
               "submit-fail-resubmit": 2}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_cases_match_and_leak_nothing(case):
    """Duplicate submits, same-window FAIL + resubmit + FINISH and the
    two interleavings: the port's schedule, stats and state equal the
    JAX package's, every submit is finished and no row stays live."""
    events_t = EDGE_CASES[case]
    events_j = [jt.TraceTaskEvent(*dataclasses.astuple(e)) for e in events_t]
    jd, td = _drivers([jt.TraceMachineEvent(0, 0, 0, cpus=4.0)],
                      [tt.TraceMachineEvent(0, 0, 0, cpus=4.0)],
                      slots_per_machine=4, num_jobs_hint=4, task_capacity=16,
                      decode_width=None)
    sch, tsch = jd.stage(events_j, window_s=5.0), td.stage(events_t, window_s=5.0)
    _assert_same_schedule(sch, tsch)
    n = EDGE_COUNTS[case]
    assert tsch["submitted"] == tsch["finished"] == n
    got = _assert_same_replay(jd, td, jd.replay(sch), td.replay(tsch))
    assert int(got["completed"].sum()) == n
    assert td.cluster.num_live_tasks == 0


def test_same_window_submit_finish_defers():
    """Tasks submitted and finished inside one window complete in the
    next round (the carry), as in the JAX package; all 80 retire."""
    (mj, ej), (mt, et) = _both_traces("short")
    jd, td = _drivers(mj, mt, slots_per_machine=4, num_jobs_hint=4, task_capacity=128,
                      decode_width=None)
    sch, tsch = jd.stage(ej, window_s=30.0), td.stage(et, window_s=30.0)
    assert tsch["finished"] == tsch["submitted"] == 80
    got = _assert_same_replay(jd, td, jd.replay(sch), td.replay(tsch))
    assert int(got["admitted"].sum()) == int(got["completed"].sum()) == 80
    assert td.cluster.num_live_tasks == 0


def test_stage_mirror_reuses_freed_rows():
    """120 tasks through a 64-row pool: the mirror hands freed rows out
    again, and the port's admissions take exactly the rows the mirror
    predicted (the later completions retire their current owners)."""
    mj, ej = jt.synthesize_trace(**dict(TRACES["plain"], seed=5))
    mt, et = tt.synthesize_trace(**dict(TRACES["plain"], seed=5))
    jd, td = _drivers(mj, mt, slots_per_machine=2, num_jobs_hint=8, task_capacity=64,
                      decode_width=None)
    sch, tsch = jd.stage(ej, window_s=10.0), td.stage(et, window_s=10.0)
    _assert_same_schedule(sch, tsch)
    assert tsch["dropped"] == 0 and tsch["submitted"] > 64
    got = _assert_same_replay(jd, td, jd.replay(sch), td.replay(tsch))
    assert int(got["admitted"].sum()) == tsch["submitted"]
    assert int(got["completed"].sum()) == tsch["finished"]


@pytest.mark.parametrize("width", [None, 4])
def test_decode_width_that_defers(width):
    """A decode window narrower than the admission peaks defers
    placements: each width matches the JAX package round for round."""
    kw = dict(num_machines=12, num_tasks=360, duration_s=60.0, mean_runtime_s=15.0, seed=9)
    mj, ej = jt.synthesize_trace(**kw)
    mt, et = tt.synthesize_trace(**kw)
    jd, td = _drivers(mj, mt, slots_per_machine=4, num_jobs_hint=4, task_capacity=512,
                      decode_width=width)
    sch, tsch = jd.stage(ej, window_s=1.0), td.stage(et, window_s=1.0)
    if width:
        assert int(tsch["adm_n"].max()) > width
    got = _assert_same_replay(jd, td, jd.replay(sch, seed=0), td.replay(tsch, seed=0))
    assert got["converged"].all()


def test_host_driver_needs_a_backend():
    """With no backend given, the host driver runs its rounds on the
    card, so where no CUDA device is present it needs one. The JAX
    package's default, the C++ native solver, is passed explicitly."""
    from ksched_tpu.solver.native import NativeSolver as JaxNative
    from ksched_tpu_torch.solver.native import NativeSolver

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.TraceReplayDriver([tt.TraceMachineEvent(0, 0, 0)])
    td = tt.TraceReplayDriver([tt.TraceMachineEvent(0, 0, 0)], backend=NativeSolver())
    jd = jt.TraceReplayDriver([jt.TraceMachineEvent(0, 0, 0)])
    assert isinstance(td.cluster.backend, NativeSolver)
    assert isinstance(jd.cluster.backend, JaxNative)


def test_no_schedulable_window_raises():
    for d in _drivers([jt.TraceMachineEvent(0, 0, 0)], [tt.TraceMachineEvent(0, 0, 0)],
                      task_capacity=16, decode_width=None):
        with pytest.raises(ValueError, match="no schedulable windows"):
            d.stage([])


def test_parse_csv_matches(tmp_path):
    """The clusterdata-2011 CSV readers (plain and gzip) read the same
    events as the JAX package's."""
    import gzip

    task_rows = ["0,,1,0,,0,u,2,9,0.25", "5000000,,1,0,,4,u,,,", "", "7,,3,1,5,1,u,1,0,"]
    machine_rows = ["0,1,0,p,0.5,0.5", "9000000,1,1,p,,", "3,2,0"]
    paths = []
    for name, rows in (("task_events.csv", task_rows), ("machine_events.csv", machine_rows)):
        p = tmp_path / name
        p.write_text("\n".join(rows) + "\n")
        gz = tmp_path / (name + ".gz")
        with gzip.open(gz, "wt") as f:
            f.write("\n".join(rows) + "\n")
        paths.append((str(p), str(gz)))
    for path in paths[0]:
        assert (_tuples(tt.parse_task_events(path)) == _tuples(jt.parse_task_events(path))
                != [])
    for path in paths[1]:
        assert (_tuples(tt.parse_machine_events(path))
                == _tuples(jt.parse_machine_events(path)) != [])


def test_replay_stats_p50():
    for cls in (tt.ReplayStats, jt.ReplayStats):
        assert cls().p50_ms == 0.0
    a, b = tt.ReplayStats(), jt.ReplayStats()
    a.round_latencies_s = b.round_latencies_s = [0.004, 0.001, 0.003]
    assert a.p50_ms == b.p50_ms == pytest.approx(3.0)
