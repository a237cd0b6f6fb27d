"""ksched_tpu_torch/bench.py's timed protocol against bench.py's, both on
the CPU, tolerance 0: `_device_bench` at `--small` (through each
package's `main`) and at a cut of coco50k-preempt's three-tier
arguments (40 machines, 1,200 tasks), every `detail` field that is not
a wall or a fit derived from walls equal (rounds_per_chunk, the bar,
placed_per_round_mean, live_final, the supersteps p50/p99/max,
top_rounds, the tier counts); `parse_overrides`' values and errors
word for word; every SUITE_CONFIGS and EXTRA_CONFIGS name dispatched
by `run_config` and accepted by `--config`; `--suite`'s children (the
port's module, `--cpu` passed on) and a failed child's FAILED line;
and no record without a card unless `--cpu` says so."""

import json
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from ksched_tpu.costmodels.device_costs import coco_device_cost_fn as jax_coco

from ksched_tpu_torch import bench as tbench
from ksched_tpu_torch.costmodels import coco
from ksched_tpu_torch.costmodels.device_costs import coco_device_cost_fn
from ksched_tpu_torch.scheduler.device_bulk import DeviceBulkCluster

#: detail fields that are walls, or fits derived from walls
TIMED = ("chunks_wall_ms", "latency_model")


def _untimed(rec):
    return {k: v for k, v in rec["detail"].items() if k not in TIMED}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread in this process and its children: the runs here
    are small, and the tier-1 workers share the host's cores (integer
    results do not depend on the thread count)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _stable_ties(monkeypatch):
    """bench.py ranks tied supersteps in top_rounds by numpy's default
    sort, whose tie order depends on the build (its SIMD sort); the port
    and its references rank ties by a stable sort."""
    from torch_bench_reference import StableArgsort

    monkeypatch.setattr(jbench, "np", StableArgsort(jbench.np))


def test_small_cpu_record_equals_bench(monkeypatch, capsys):
    """`python -m ksched_tpu_torch.bench --small --cpu` against `python
    bench.py --small --cpu`: one JSON record each, the same metric and
    non-timing detail."""
    monkeypatch.setattr(sys, "argv", ["bench.py", "--small", "--cpu"])
    jbench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lines = []
    assert tbench.main(["--small", "--cpu"], log=lines.append) == 0
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["metric"] == want["metric"]
    assert set(got["detail"]) == set(want["detail"])
    assert _untimed(got) == _untimed(want)
    assert got["detail"]["floor_bar_ms"] == 0.0
    assert got["detail"]["rounds_per_chunk"] == 64 and len(got["detail"]["chunks_wall_ms"]) == 3


#: coco50k-preempt's three-tier arguments (bench.py:1639-1705), cut to
#: 40 machines and 1,200 tasks, the windows cut with them
M, T = 40, 1200
PREEMPT_KW = dict(num_task_classes=4, unsched_cost=coco.UNSCHEDULED_COST, ec_cost=0,
                  supersteps=1 << 17, preemption=True, continuation_discount=8,
                  preempt_every=16, preempt_drift=10_000, preempt_global_every=128,
                  preempt_scope_tau=16, preempt_incr_budget=8192,
                  preempt_scoped_width=1024, decode_width=512)


def test_preempt_cut_detail_equals_bench():
    """The two-regime config: 7 measured chunks of 16 rounds after the
    warm-up and probe chunks (seeds 1, 1, 2..8), the tiers' counts,
    top_rounds with their tiers and drifts, the scoped and global
    spreads; the mixture fit's kind."""
    pen = np.random.default_rng(7).integers(0, 40, (M, 4)).astype(np.int64)
    want = jbench._device_bench(tasks=T, machines=M, pus=4, slots=16, jobs=20, churn=0.01,
                                rounds=16, chunk=16, class_cost_fn=jax_coco(pen),
                                **PREEMPT_KW)
    cluster = DeviceBulkCluster(num_machines=M, pus_per_machine=4, slots_per_pu=16,
                                num_jobs=20, task_capacity=8192,
                                class_cost_fn=coco_device_cost_fn(pen), device="cpu",
                                **PREEMPT_KW)
    got = tbench._device_bench(cluster, tasks=T, churn=0.01, rounds=16, chunk=16)
    assert got["metric"] == want["metric"]
    assert set(got["detail"]) == set(want["detail"])
    assert _untimed(got) == _untimed(want)
    d = got["detail"]
    assert len(d["chunks_wall_ms"]) == 7 and d["rounds_total"] == 112
    assert d["full_rounds"] > 0 and d["global_rounds"] == 1
    assert {r["tier"] for r in d["top_rounds"]} <= {"incremental", "scoped", "global",
                                                    "escalated"}
    assert "per_superstep_us_full" in d["latency_model"] or d["latency_model"]["fit"] != \
        "lstsq-2regime"


OVERRIDE_CASES = [
    ([], ("a", "b")),
    (["a=1"], ("a",)),
    (["a=1", "b=2.5"], ("a", "b")),
    (["rate=1e5"], ("rate",)),
    (["a=-3"], ("a",)),
    (["a"], ("a",)),
    (["a=x"], ("a",)),
    (["a=inf"], ("a",)),
    (["a=nan"], ("a",)),
    (["c=1"], ("a", "b")),
    (["a=1", "z=2", "y=3"], ("a",)),
    (["a=="], ("a",)),
]


@pytest.mark.parametrize("pairs,allowed", OVERRIDE_CASES,
                         ids=[" ".join(p) or "none" for p, _ in OVERRIDE_CASES])
def test_parse_overrides_equals_bench(pairs, allowed):
    def outcome(fn):
        try:
            return ("ok", fn(pairs, allowed))
        except SystemExit as e:
            return ("exit", str(e))

    assert outcome(tbench.parse_overrides) == outcome(jbench.parse_overrides)


#: the arm each config dispatches to
ARMS = {name: "device_config_bench" for name in tbench.DEVICE_CONFIGS}
ARMS.update({"quincy10k-multiblock": "_quincy_multiblock_bench",
             "gtrace12k": "_gtrace_device_bench", "gtrace12k-burst": "_gtrace_device_bench",
             "gtrace12k-coco": "_gtrace_device_bench",
             "gtrace12k-host": "_gtrace_host_bench", "churn": "_churn_pipeline_bench",
             "multitenant": "_multitenant_bench", "gtrace100k": "_sharded_scale_bench",
             "mcmf-mega": "run_bench"})


@pytest.mark.parametrize("name", jbench.SUITE_CONFIGS + jbench.EXTRA_CONFIGS)
def test_every_config_is_dispatched(monkeypatch, name):
    """Every name of bench.py's SUITE_CONFIGS + EXTRA_CONFIGS reaches its
    arm through run_config (the arms stubbed) and --config accepts it."""
    from ksched_tpu_torch.tools import mega_bench

    called = []

    def stub(arm):
        def fn(*a, **k):
            called.append(arm)
            return {"detail": {}}
        return fn

    for arm in set(ARMS.values()):
        monkeypatch.setattr(mega_bench if arm == "run_bench" else tbench, arm, stub(arm))
    out = tbench.run_config(name, device="cpu")
    assert called == [ARMS[name]] and out["config"] == name
    assert tbench.parser().parse_args(["--config", name]).config == name


def test_unknown_config_and_overrides_refused():
    with pytest.raises(SystemExit, match="unknown config"):
        tbench.run_config("no-such-config", device="cpu")
    with pytest.raises(SystemExit, match="unknown --override keys"):
        tbench.run_config("ref100", overrides=["tasks=5"], device="cpu")
    with pytest.raises(SystemExit):
        tbench.parser().parse_args(["--config", "no-such-config"])


def test_no_card_raises_without_cpu(monkeypatch):
    """Without a card the bench raises unless --cpu asks for the CPU:
    no probe, no switch to another device, no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lines = []
    for argv in ([], ["--small"], ["--config", "ref100"], ["--suite"],
                 ["--backend", "layered", "--small"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbench.main(argv, log=lines.append)
    assert lines == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_config("ref100")


def test_suite_children_and_failed_line(monkeypatch, tmp_path):
    """--suite: one child `python -m ksched_tpu_torch.bench --config NAME
    ... --cpu` a config, the artifact rewritten after each; a child that
    fails writes its FAILED line with the error."""
    import subprocess

    monkeypatch.setattr(tbench, "SUITE_CONFIGS", ("ref100", "no-such-config"))
    cmds = []
    real_run = subprocess.run

    def spy(cmd, **kw):
        cmds.append(list(cmd))
        return real_run(cmd, **kw)

    monkeypatch.setattr(subprocess, "run", spy)
    out_path = tmp_path / "suite.jsonl"
    lines = []
    assert tbench.main(["--suite", "--cpu", "--suite-out", str(out_path)],
                       log=lines.append) == 0
    children = [c for c in cmds if "-m" in c]
    assert [c[c.index("--config") + 1] for c in children] == ["ref100", "no-such-config"]
    assert all(c[1:3] == ["-m", "ksched_tpu_torch.bench"] and "--cpu" in c
               for c in children)
    rows = [json.loads(x) for x in out_path.read_text().splitlines()]
    assert rows[0]["suite_stamp"] and rows[0]["platform"] == "cpu"
    assert rows[0]["torch"] == torch.__version__ and rows[0]["card"] is None
    assert rows[1]["config"] == "ref100" and rows[1]["value"] > 0
    assert rows[1]["detail"]["floor_bar_ms"] == 0.0
    assert rows[2]["metric"] == "config no-such-config FAILED" and rows[2]["value"] is None
    assert "invalid choice" in rows[2]["error"]
    assert [json.loads(x) for x in lines] == rows[1:]


def test_suite_refuses_trace_and_obs_out():
    with pytest.raises(SystemExit):
        tbench.main(["--suite", "--cpu", "--obs-out", "x.json"])


def test_host_backend_path(tmp_path):
    """The host --backend path (bench.py's `_run_bulk_bench`) on the CPU:
    one record, the obs snapshot written with the rounds' series."""
    lines = []
    obs = tmp_path / "obs.json"
    assert tbench.main(["--backend", "layered", "--cpu", "--tasks", "200", "--machines",
                        "20", "--rounds", "3", "--obs-out", str(obs)],
                       log=lines.append, err=lambda *a: None) == 0
    rec = json.loads(lines[0])
    assert rec["metric"].endswith("backend=layered/cpu") and rec["value"] > 0
    assert "ksched_rounds_total" in obs.read_text()
