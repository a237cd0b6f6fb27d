"""ksched_tpu_torch/tools/obs_report.py against ksched_tpu's
tools/obs_report.py, tolerance 0: the five artifact kinds a 6 x 8 chaos
soak of the port writes (its RoundRecord JSONL, registry snapshot,
flight dump with solver stalls, Chrome span trace of the pipelined loop,
and its solver's telemetry JSON), each rendered by both readers with
identical output; the per-tenant view and the pipeline-occupancy view
included, and the port's superstep tracer's `--out` file."""

import contextlib
import glob
import io
import json

import numpy as np
import pytest

from tools import obs_report as jrep

from ksched_tpu_torch.tools import obs_report as trep


def _render(fn, path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(str(path), "ksched_round_phase_ms")
    return buf.getvalue()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One 6 x 8 chaos soak of the port (pipelined loop, a solver
    outage probability that forces NOOP rounds and their flight dumps,
    solver telemetry on) and the five artifacts it leaves."""
    from ksched_tpu_torch.drivers import soak
    from ksched_tpu_torch.obs import soltel

    from torch_service_reference import soak_args

    d = tmp_path_factory.mktemp("obs")
    was = soltel.enabled()
    soltel.set_enabled(True)
    try:
        args = soak_args(rounds=48, chunk=16, seed=0, machines=6, slots=8,
                         chaos_restore_every=0, loop="pipelined",
                         flight_dir=str(d / "flight"), solver_outage_prob=0.2,
                         assert_stall_flight=True, obs_out=str(d / "snapshot.json"),
                         device="cpu")
        res = soak.run_chaos_soak(args, lambda *a, **k: None)
    finally:
        soltel.set_enabled(was)
    res["tracer"].dump(str(d / "rounds.jsonl"))
    res["span_tracer"].dump(str(d / "trace.json"))
    tel = res["service"].ladder.last_telemetry
    assert tel is not None
    with open(d / "telemetry.json", "w") as f:
        json.dump({"solver_telemetry": tel.to_dict()}, f)
    flights = sorted(glob.glob(str(d / "flight" / "flight_*.json")))
    assert flights
    # the per-tenant view: the same records, tagged as two cells' rounds
    with open(d / "rounds.jsonl") as f, open(d / "tenants.jsonl", "w") as g:
        for i, line in enumerate(f):
            rec = json.loads(line)
            rec["tenant"] = ("cell-a", "cell-b")[i % 2]
            g.write(json.dumps(rec) + "\n")
    return {"jsonl": d / "rounds.jsonl", "snapshot": d / "snapshot.json",
            "flight": flights[-1], "trace": d / "trace.json",
            "telemetry": d / "telemetry.json", "tenants": d / "tenants.jsonl"}


@pytest.mark.parametrize("kind", ["jsonl", "snapshot", "flight", "trace", "telemetry",
                                  "tenants"])
def test_port_renders_each_artifact_as_the_jax_tool(artifacts, kind):
    got = _render(trep.load_and_report, artifacts[kind])
    want = _render(jrep.load_and_report, artifacts[kind])
    assert got == want
    # each artifact took its own branch of the reader
    marker = {"jsonl": "rounds: ", "snapshot": "counter/gauge", "flight": "flight dump:",
              "trace": "trace: ", "telemetry": "solver telemetry:",
              "tenants": "per-tenant (total phase):"}[kind]
    assert marker in got
    if kind == "flight":
        assert "solver stalls:" in got
    if kind == "trace":
        assert "pipeline occupancy:" in got


def test_pipeline_occupancy_equals_the_jax_tools(artifacts):
    with open(artifacts["trace"]) as f:
        events = json.load(f)["traceEvents"]
    got = trep.pipeline_occupancy(events)
    assert got is not None and got == jrep.pipeline_occupancy(events)


def test_superstep_trace_out_renders_alike(tmp_path):
    from ksched_tpu_torch.tools import superstep_trace as ttrace

    rng = np.random.default_rng(5)
    C, M, Mp = 3, 6, 8
    w = rng.integers(-40, 10, (C, M))
    np.savez(tmp_path / "inst.npz", n=1, Mp=Mp, w_0=w,
             supply_0=np.array([5, 7, 4]),
             colcap_0=np.concatenate([rng.integers(1, 4, M), [0], [16]]))
    out = tmp_path / "tel.json"
    assert ttrace.main(["--inst", str(tmp_path / "inst.npz"), "--out", str(out),
                        "--n-scale", "16"], log=lambda *a, **k: None) == 0
    got = _render(trep.load_and_report, out)
    assert got == _render(jrep.load_and_report, out)
    assert got.startswith("solver telemetry: backend=superstep_trace")


def test_main_prints_the_table(artifacts, capsys):
    assert trep.main([str(artifacts["jsonl"])]) == 0
    assert capsys.readouterr().out == _render(jrep.load_and_report, artifacts["jsonl"])


def test_empty_dump(tmp_path, capsys):
    (tmp_path / "e.json").write_text("\n")
    trep.load_and_report(str(tmp_path / "e.json"))
    assert capsys.readouterr().err == "empty dump\n"
