"""The harness on the CPU at a small size: the metric arithmetic, the
result line's keys, and BENCHMARK.json against the benchmark's rules."""

import json
import re
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests.small import QUINCY, STEADY

CELL = "quincy10k-multiblock.steady"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_p95_is_over_all_rounds_and_rate_over_all_time():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    got = harness.end_to_end(lat, placed=500, window_s=2.0, setup_s=3.5)
    assert got["round_ms_p50"] == pytest.approx(50.5)
    assert got["round_ms_p95"] == pytest.approx(95.05)
    assert got["placements_per_s"] == 250.0
    assert got["setup_s"] == 3.5


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    bench = harness.load_benchmark()
    line, faults = harness.run_cell(bench, CELL, QUINCY, STEADY, 2**31 + 11, 1.0, trace,
                                    "cpu", time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and not faults
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in harness.cell_metrics(bench, CELL, trace)}
    assert set(line["metrics"]) <= set(want)
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(want)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_the_cli_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_benchmark_json_keeps_the_rules():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = {c["name"]: c for c in bench["workloads"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    for n in names + list(cells) + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(cells) == len(bench["workloads"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/") and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert (harness.HERE / "systems" / f"{cfg['system']}.py").exists()
        assert (harness.HERE / "reference" / f"{cfg['reference']}.py").exists()
    for cell in cells.values():
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in names and cell["chips"] == 1 and len(cell["why"]) <= 200
        assert (harness.HERE / "traffic" / f"{cell['traffic']}.json").exists()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", [])) <= set(cells)
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        got = harness.cell_metrics(bench, cell, True)
        reported = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
        assert got and "setup_s" in reported and len(reported) >= 2
        # each per-layer metric moves an end-to-end metric its cell reports
        assert all(m["moves"] in reported for m in got), cell


def test_a_per_layer_metric_is_selected_by_its_workloads_alone():
    bench = {"end_to_end": [{"name": "e", "workloads": ["a"]}],
             "per_layer": [{"name": "x", "moves": "e"},
                           {"name": "y", "moves": "f", "workloads": ["b"]}]}
    assert [m["name"] for m in harness.cell_metrics(bench, "a", True)] == ["x"]
    assert [m["name"] for m in harness.cell_metrics(bench, "b", True)] == ["x", "y"]
    assert [m["name"] for m in harness.cell_metrics(bench, "b", False)] == []
