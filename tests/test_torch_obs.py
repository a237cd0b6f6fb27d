"""The port's observability modules (ksched_tpu_torch/obs: metrics,
exporter, flight, devprof) against the JAX package's (ksched_tpu/obs),
and the slice as a whole (tolerance 0: all of it is integers and text):

- the same sequence of metric operations on a JAX Registry and a port
  Registry renders the same Prometheus text, which parse_prometheus
  round-trips; the cases of tests/test_obs.py that need no JAX;
- flight dumps equal up to their timestamps;
- DeviceProfiler's accounting, and its torch.profiler capture of the
  Nth solve (CPU activity here);
- Scenario W(20, 200) through FlowScheduler → PlacementSolver with
  "mega" (kernel B3's plain version) and with the CSR rung, rounds 0-2,
  in both packages: their registries' Prometheus texts equal
  (ksched_solves_total, ksched_h2d_bytes_total, the superstep
  histograms, the stall counters). The JAX side's mega kernel is the
  stand-in of tests/torch_event_mega_reference.py.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import ksched_tpu.obs as J
import ksched_tpu_torch.obs as T
from ksched_tpu.obs import metrics as j_metrics
from ksched_tpu_torch.obs import metrics as t_metrics

PKGS = [pytest.param(J, id="jax"), pytest.param(T, id="port")]


def _drive(reg):
    """One fixed sequence of metric operations on `reg`."""
    c = reg.counter("ksched_ops_total", "ops by kind", labelnames=("kind",))
    c.labels(kind="a").inc()
    c.labels("b").inc(2.5)
    c.labels(kind='q"u\\o\nte').inc(3)
    reg.counter("ksched_plain_total", "plain").inc(7)
    g = reg.gauge("ksched_level", "a gauge")
    g.set(12)
    g.dec(4.5)
    g.inc()
    h = reg.histogram("ksched_work", "work", labelnames=("backend",),
                      buckets=(1, 2, 4, 8))
    for v, b in ((0.5, "x"), (1, "x"), (3, "y"), (9, "x"), (8, "y"), (2, "x")):
        h.labels(backend=b).observe(v)
    hd = reg.histogram("ksched_default_ms", "default buckets")
    for v in (0.004, 1.5, 70000):
        hd.observe(v)
    s = reg.scoped(tenant="t1")
    s.counter("ksched_scoped_total", "scoped", labelnames=("k",)).labels(k="z").inc(4)
    s.scoped(shard="0").gauge("ksched_scoped_level", "nested").set(-2)


def test_registry_texts_match_jax():
    jreg, treg = J.Registry(), T.Registry()
    _drive(jreg)
    _drive(treg)
    text = T.render_prometheus(treg)
    assert text == J.render_prometheus(jreg)
    parsed = T.parse_prometheus(text)
    assert parsed == J.parse_prometheus(text)
    assert parsed[("ksched_ops_total", (("kind", 'q"u\\o\nte'),))] == 3
    assert parsed[("ksched_work_count", (("backend", "x"),))] == 4
    assert treg.snapshot() == jreg.snapshot()
    for name, labels in (("ksched_ops_total", {"kind": "b"}), ("ksched_level", {}),
                         ("ksched_work", {"backend": "y"}), ("ksched_missing", {})):
        assert treg.value(name, **labels) == jreg.value(name, **labels)


@pytest.mark.parametrize("mod", PKGS)
def test_counter_gauge_histogram_basics(mod):
    reg = mod.Registry()
    c = reg.counter("c_total", "a counter")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g", "a gauge")
    g.set(7)
    g.dec(3)
    assert g.value == 4
    h = reg.histogram("h_ms", "a histogram", buckets=(1, 2, 4))
    for v in (0.5, 1.5, 3, 100):
        h.observe(v)
    assert h.count == 4 and h.sum == 105.0


def _errors(mod):
    """The messages of the registry's refusals, in order."""
    reg = mod.Registry()
    fam = reg.counter("ev_total", "events", labelnames=("kind",))
    assert reg.counter("ev_total", labelnames=("kind",)) is fam
    h = reg.histogram("lat2_ms", "latency", buckets=(1, 2, 4))
    assert reg.histogram("lat2_ms") is h
    out = []
    for bad in (lambda: reg.gauge("ev_total"),
                lambda: reg.counter("ev_total", labelnames=("other",)),
                lambda: reg.counter("bad name!"),
                lambda: reg.histogram("lat2_ms", buckets=(1, 2, 8)),
                lambda: fam.labels(kind="a", extra="b"),
                lambda: fam.inc(),
                lambda: mod.log_buckets(0, 10),
                lambda: reg.scoped(tenant="a").counter("c", labelnames=("tenant",))):
        with pytest.raises(ValueError) as e:
            bad()
        out.append(str(e.value))
    return out


def test_registry_refusals_match_jax():
    assert _errors(T) == _errors(J)
    assert T.log_buckets(1, 64, 2.0) == J.log_buckets(1, 64, 2.0) == (1, 2, 4, 8, 16, 32, 64)
    assert T.DEFAULT_MS_BUCKETS == J.DEFAULT_MS_BUCKETS


@pytest.mark.parametrize("mod", PKGS)
def test_exposition_bucket_monotonicity_and_sum_count(mod):
    reg = mod.Registry()
    h = reg.histogram("lat_ms", "latency", buckets=(1, 10, 100))
    samples = [0.5, 0.5, 5, 50, 500, 7, 1]
    for v in samples:
        h.observe(v)
    parsed = mod.parse_prometheus(mod.render_prometheus(reg))
    buckets = sorted(
        (float("inf") if dict(k[1])["le"] == "+Inf" else float(dict(k[1])["le"]), v)
        for k, v in parsed.items() if k[0] == "lat_ms_bucket")
    counts = [v for _, v in buckets]
    assert counts == sorted(counts)
    assert counts[-1] == parsed[("lat_ms_count", ())] == len(samples)
    assert parsed[("lat_ms_sum", ())] == pytest.approx(sum(samples))
    assert buckets[0] == (1.0, 3)


def test_exposition_served_over_http():
    reg = T.Registry()
    _drive(reg)
    srv = T.MetricsServer(port=0, registry=reg)
    try:
        with urllib.request.urlopen(srv.url + "/metricsz", timeout=5) as r:
            assert "version=0.0.4" in r.headers["Content-Type"]
            assert r.read().decode() == T.render_prometheus(reg)
        assert T.scrape(srv.url + "/metrics") == T.parse_prometheus(T.render_prometheus(reg))
        with urllib.request.urlopen(srv.url + "/healthz", timeout=5) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(srv.url + "/varz", timeout=5) as r:
            assert json.loads(r.read()) == json.loads(json.dumps(reg.snapshot()))
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(srv.url + "/nope", timeout=5)
        assert exc.value.code == 404
    finally:
        srv.stop()


def test_registry_dumps_match_jax(tmp_path):
    docs = []
    for mod in (J, T):
        reg = mod.Registry()
        _drive(reg)
        path = tmp_path / f"{mod.__name__}.json"
        mod.dump_registry(reg, str(path))
        doc = json.loads(path.read_text())
        assert doc.pop("captured_at") > 0
        docs.append(doc)
    assert docs[0] == docs[1]


@pytest.mark.parametrize("pair", [(j_metrics, J), (t_metrics, T)], ids=["jax", "port"])
def test_disabled_obs_is_inert(pair):
    metrics, mod = pair
    assert metrics.enabled()
    metrics.set_enabled(False)
    try:
        reg = metrics.get_registry()
        assert reg is mod.NULL_REGISTRY
        c = reg.counter("anything_total", "x", labelnames=("k",))
        c.labels(k="a").inc(100)
        c.inc()
        c.observe(5)
        assert c.value == 0 and reg.collect() == [] and reg.snapshot() == {}
        assert mod.render_prometheus(reg) == ""
        if mod is T:
            assert T.soltel.resolve_cap(None) == 0  # KSCHED_OBS=0 turns rings off
    finally:
        metrics.set_enabled(True)


def test_scoped_registry_nests_and_is_thread_confined():
    base = t_metrics.get_registry()
    with T.scoped_registry() as outer:
        outer.counter("outer_total", "x").inc()
        with T.scoped_registry() as inner:
            assert t_metrics.get_registry() is inner
        assert t_metrics.get_registry() is outer
    assert t_metrics.get_registry() is base
    errors = []
    barrier = threading.Barrier(3)

    def run(i):
        try:
            with T.scoped_registry() as reg:
                barrier.wait(timeout=5)
                reg.counter("private_total", "x").inc(i + 1)
                barrier.wait(timeout=5)
                assert reg.value("private_total") == i + 1
                assert t_metrics.get_registry() is reg
        except Exception as e:  # noqa: BLE001 — surfaced via the errors list
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errors and t_metrics.get_registry() is base
    a, b = T.scoped_registry(), T.scoped_registry()
    a.__enter__()
    b.__enter__()
    with pytest.raises(RuntimeError):
        a.__exit__(None, None, None)
    b.__exit__(None, None, None)
    a.__exit__(None, None, None)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Rec:
    round_index: int
    deadline_miss: bool = False
    noop_round: bool = False


def _flight(mod, soltel, tmp_path, tag):
    """A fixed sequence of rounds, stalls and triggers on one package's
    FlightRecorder; its dumps (timestamps dropped) and dump counts."""
    soltel.reset_stalls()
    reg = mod.Registry()
    d = tmp_path / tag
    with mod.scoped_registry():
        with soltel.stall_scope("tenant_a"):
            soltel.note_stall({"kind": "excess_plateau"})
        soltel.note_stall({"kind": "backend_error"})
        fl = mod.FlightRecorder(capacity=3, dump_dir=str(d), registry=reg,
                                min_rounds_between_dumps=3, scope="tenant_a")
        paths = [fl.note_round(Rec(i), [{"ph": "X", "name": f"r{i}"}]) for i in range(3)]
        paths.append(fl.note_round(Rec(3, deadline_miss=True)))
        paths.append(fl.note_round(Rec(4, noop_round=True)))
        paths.append(fl.note_round(Rec(5, deadline_miss=True)))  # rate-limited
        paths.append(fl.trigger("divergence"))
        paths.append(fl.dump("manual"))
    docs = []
    for p in paths:
        if p is None:
            docs.append(None)
            continue
        doc = json.loads(open(p).read())
        assert doc.pop("captured_at") > 0
        for s in doc["solver_stalls"]:
            s.pop("ts")
        docs.append((os.path.basename(p), doc))
    soltel.reset_stalls()
    counts = {r: reg.value("ksched_flight_dumps_total", reason=r)
              for r in ("deadline_miss", "noop_round", "divergence", "manual")}
    return docs, counts


def test_flight_dumps_match_jax(tmp_path):
    from ksched_tpu.obs import soltel as jsol
    from ksched_tpu_torch.obs import soltel as tsol

    want = _flight(J, jsol, tmp_path, "jax")
    got = _flight(T, tsol, tmp_path, "port")
    assert got == want
    docs, counts = got
    assert docs[2] is None and docs[5] is None and counts["deadline_miss"] == 1
    assert {s["kind"] for s in docs[3][1]["solver_stalls"]} == {
        "excess_plateau", "backend_error"}


def test_flight_crash_hook_chains(tmp_path):
    import sys

    fl = T.FlightRecorder(capacity=2, dump_dir=str(tmp_path), registry=T.Registry())
    fl.note_round(Rec(0))
    seen = []
    prev_hook = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a)
    try:
        fl.install_crash_hook()
        fl.install_crash_hook()  # idempotent
        try:
            raise ValueError("simulated crash")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        assert len(seen) == 1 and len(fl.dumps) == 1 and "crash" in fl.dumps[0]
    finally:
        fl.uninstall_crash_hook()
        sys.excepthook = prev_hook


# ---------------------------------------------------------------------------
# devprof
# ---------------------------------------------------------------------------


class _P:
    num_arcs = 7
    num_nodes = 5
    cost = np.zeros(7, np.int32)
    cap = np.zeros(7, np.int32)


class _Stats:
    nodes_added = 2
    nodes_removed = 1
    arcs_added = 3
    arcs_changed = 4
    arcs_removed = 0


class _Arc:
    src, dst = 1, 2


class _Node:
    pass


def _devprof(mod, render):
    from importlib import import_module

    dp = import_module(mod.__name__ + ".devprof")
    reg = mod.Registry()
    prof = dp.DeviceProfiler(registry=reg)
    prof.note_export(_P(), full=True)
    prof.note_export(_P(), full=False, stats=_Stats())
    prof.note_export(_P(), full=False, changes=[_Arc(), _Arc(), _Node()])
    prof.note_export(_P(), full=True, exact_bytes=1234)
    prof.note_export(_P(), full=False, exact_bytes=56)

    class Backend:
        last_rung_name = "jax"
        last_iterations = 12

    class Result:
        iterations = 0

    class Plain:
        last_supersteps = 5

    prof.solve_starting()
    prof.note_solve(Backend(), _P(), Result())
    prof.solve_starting()
    prof.note_solve(Plain(), _P(), Result())
    prof.solve_failed()
    lines = [ln for ln in render(reg).splitlines()
             if not ln.startswith("# HELP ksched_devprof_captures_total")]
    return lines, (dp.delta_nbytes(_Stats()), dp.journal_nbytes([_Arc(), _Node()]),
                   dp.problem_nbytes(_P()))


def test_devprof_accounting_matches_jax():
    got = _devprof(T, T.render_prometheus)
    assert got == _devprof(J, J.render_prometheus)
    text = "\n".join(got[0])
    assert 'ksched_h2d_bytes_total{kind="full_build"} 1290' in text
    assert 'ksched_solves_total{backend="Plain"} 1' in text


def test_devprof_captures_the_nth_solve(tmp_path):
    """capture_solve=2: torch.profiler brackets the second solve only
    (CPU activity here), writes its Chrome trace and counts it."""
    import torch

    from ksched_tpu_torch.obs.devprof import DeviceProfiler

    reg = T.Registry()
    prof = DeviceProfiler(registry=reg, capture_solve=2, capture_dir=str(tmp_path / "cap"))
    for i in range(3):
        prof.solve_starting()
        torch.arange(1000).sum()
        prof.note_solve(object(), _P(), type("R", (), {"iterations": i + 1})())
    assert reg.value("ksched_devprof_captures_total") == 1
    assert prof.last_capture_path == str(tmp_path / "cap" / "solve_2.json")
    trace = json.loads(open(prof.last_capture_path).read())
    assert any("sum" in ev.get("name", "") for ev in trace["traceEvents"])
    assert prof.last_capture.key_averages() is not None


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _jax_rounds(backend_name, rounds):
    """W(20, 200) through the JAX package's FlowScheduler, its registry
    text and the soltel rings' sha256 per round."""
    import ksched_tpu.ops.mcmf_pallas as mp
    from ksched_tpu.obs import devprof, soltel
    from ksched_tpu.solver.jax_solver import JaxSolver
    from ksched_tpu.solver.mega_solver import MegaSolver
    from torch_event_mega_reference import mega_standin, scenario_rounds, telemetry_sha256

    backend = (MegaSolver(fallback=JaxSolver()) if backend_name == "mega"
               else JaxSolver())
    saved = mp.mcmf_loop_pallas
    mp.mcmf_loop_pallas = mega_standin
    soltel.reset_stalls()
    try:
        with J.scoped_registry() as reg:
            devprof.set_profiler(devprof.DeviceProfiler(registry=reg))
            shas = []
            for r, _sched, _placed in scenario_rounds("W", 20, 200, backend):
                shas.append(telemetry_sha256(backend.last_telemetry))
                if r == rounds - 1:
                    break
            text = J.render_prometheus(reg)
    finally:
        mp.mcmf_loop_pallas = saved
        devprof.set_profiler(None)
        soltel.reset_stalls()
    return text, shas


def _port_rounds(backend_name, rounds):
    from ksched_tpu_torch.drivers import whare_mixed_rounds
    from ksched_tpu_torch.drivers.churn import telemetry_sha256
    from ksched_tpu_torch.obs import devprof, soltel
    from ksched_tpu_torch.solver.select import make_backend

    backend = make_backend(backend_name, device="cpu")
    soltel.reset_stalls()
    try:
        with T.scoped_registry() as reg:
            devprof.set_profiler(devprof.DeviceProfiler(registry=reg))
            shas = []
            for r, _sched, _placed in whare_mixed_rounds(20, 200, backend):
                shas.append(telemetry_sha256(backend.last_telemetry))
                if r == rounds - 1:
                    break
            text = T.render_prometheus(reg)
    finally:
        devprof.set_profiler(None)
        soltel.reset_stalls()
    return text, shas


def _comparable(text):
    """The exposition without HELP lines (the capture counter's names
    its profiler) and with the CSR backend under the JAX package's class
    name (JaxSolver is the port's CsrSolver)."""
    return "\n".join(ln.replace('backend="CsrSolver"', 'backend="JaxSolver"')
                     for ln in text.splitlines() if not ln.startswith("# HELP"))


@pytest.fixture
def soltel_on():
    """Telemetry on in both packages (the suite's conftest turns the JAX
    package's off by default, and the port reads the same switch)."""
    from ksched_tpu.obs import soltel as jsol
    from ksched_tpu_torch.obs import soltel as tsol

    prior = (jsol.enabled(), tsol.enabled())
    jsol.set_enabled(True)
    tsol.set_enabled(True)
    yield
    jsol.set_enabled(prior[0])
    tsol.set_enabled(prior[1])


@pytest.mark.parametrize("backend,rounds", [("mega", 3), ("jax", 2)])
def test_scenario_w_registry_matches_jax(backend, rounds, soltel_on):
    """W(20, 200) rounds through the event path in both packages with
    soltel and the device profiler on: the registries' Prometheus texts
    are equal, and so are the per-round rings."""
    want_text, want_shas = _jax_rounds(backend, rounds)
    got_text, got_shas = _port_rounds(backend, rounds)
    assert got_shas == want_shas and None not in got_shas
    assert _comparable(got_text) == _comparable(want_text)
    for series in ("ksched_solves_total", "ksched_h2d_bytes_total",
                   "ksched_solve_supersteps_count", "ksched_solve_pushes_total"):
        assert series in got_text
