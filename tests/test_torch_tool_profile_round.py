"""ksched_tpu_torch/tools/profile_round.py on the CPU at a small
geometry: every measurement is a span of the session's tracer (the
launch chains, the synchronize round trips, the steady chunks), the
Chrome trace it writes is there and renders alike in the port's and the
JAX package's obs_report, every chained round converged, and each timed
chain's stats equal the JAX package's for tools/profile_round.py's
round sequence. No time is compared: a CPU time is not the card's."""

import contextlib
import io
import json
from collections import Counter

import pytest
import torch

from tools import obs_report as jrep
from torch_tools_reference import jax_profile

from ksched_tpu_torch.tools import obs_report as trep
from ksched_tpu_torch.tools import profile_round

SMALL = dict(M=20, P=2, S=2, J=4, T=60, Tcap=128)
#: the tool's own spans; the device rounds' spans nest under them
TOOL_SPANS = ("setup", "fill_round", "launch_chain_warmup", "launch_chain",
              "sync_round_trip", "steady_warmup", "steady_chunk")


def _tool_events(events):
    return [ev for ev in events if ev["name"] in TOOL_SPANS]


@pytest.fixture(scope="module")
def session():
    lines = []
    out = profile_round.profile("cpu", geometry=SMALL, rounds=8, reps=3,
                                log=lambda s, **k: lines.append(s))
    return out, lines


def test_every_measurement_is_a_span(session):
    out, lines = session
    events = out["tracer"].events()
    names = Counter(ev["name"] for ev in _tool_events(events))
    assert names == {"setup": 1, "fill_round": 1, "launch_chain_warmup": 1,
                     "launch_chain": 3, "sync_round_trip": 3, "steady_warmup": 1,
                     "steady_chunk": 3}
    # every other span is the program's, inside one of the tool's
    by_sid = {ev["args"]["sid"]: ev for ev in events}
    for ev in events:
        if ev["name"] not in TOOL_SPANS:
            root = ev
            while "parent_sid" in root["args"]:
                root = by_sid[root["args"]["parent_sid"]]
            assert root["name"] in TOOL_SPANS, ev["name"]
    chunks = [ev for ev in out["tracer"].events() if ev["name"] == "steady_chunk"]
    assert [ev["args"]["rounds"] for ev in chunks] == [8, 8, 8]
    assert out["converged"] is True
    assert out["launch_us"] == out["launch_chain_ms"] / 8 * 1e3
    assert out["steady_round_us"] == out["steady_chunk_ms"] / 8 * 1e3
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "geometry", "launch floor", "sync round trip", "steady round chain"]


def test_timed_chains_match_the_jax_package(session):
    out, _ = session
    assert out["chunks_sha256"] == jax_profile(**SMALL, R=8, reps=3)


def test_trace_file_renders_alike(session, tmp_path):
    out, _ = session
    path = tmp_path / "profile_round_trace.json"
    out["tracer"].dump(str(path))
    with open(path) as f:
        doc = json.load(f)
    assert len(_tool_events(e for e in doc["traceEvents"] if e.get("ph") == "X")) == 13

    def render(fn):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(str(path), "ksched_round_phase_ms")
        return buf.getvalue()

    got = render(trep.load_and_report)
    assert got == render(jrep.load_and_report)
    assert "steady_chunk" in got and "launch_chain" in got


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_round.main(["--trace-out", ""])
