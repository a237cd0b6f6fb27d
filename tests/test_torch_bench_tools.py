"""The bench's tools in ksched_tpu_torch/tools/ against ksched_tpu's
tools/ on the CPU, tolerance 0: bench_compare's `append`, `gate` and
`show` on the same seeded trajectories (equal text and exit codes, the
appended entries equal but for their time stamp); assemble_model_check
on the same inputs; mega_bench at a tiny graph (plain B3, CSR and ELL
flows and objectives equal, and equal to the JAX package's solve; the
supersteps equal to the JAX tool's); model_check's chains on captured
tails (the supersteps of every rep equal to the JAX tool's chain);
coco_anatomy's supersteps at a cut size against bench.py's
`_device_bench` with the JAX tool's arguments; csr_bench and
primitives_bench records."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from torch_tools_cases import small_config

from ksched_tpu_torch.tools import assemble_model_check as tamc
from ksched_tpu_torch.tools import coco_anatomy as tanat
from ksched_tpu_torch.tools import csr_bench as tcsr
from ksched_tpu_torch.tools import mega_bench as tmega
from ksched_tpu_torch.tools import model_check as tmc
from ksched_tpu_torch.tools import primitives_bench as tprim
from ksched_tpu_torch.tools import tail_repro as ttail

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _trajectory(seed, n=24):
    """Seeded entries over three configs, three platforms and two mesh
    sizes, some with supersteps, a fallback stamp or no p50."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = {"utc": f"2026-01-01T00:00:{i:02d}Z", "commit": f"c{i}",
             "config": ["a", "b", "churn"][int(rng.integers(0, 3))],
             "platform": ["cpu", "cuda", "tpu"][int(rng.integers(0, 3))],
             "metric": "m", "p50_ms": round(float(rng.uniform(5, 15)), 3)}
        if rng.random() < 0.15:
            e["p50_ms"] = None
        if rng.random() < 0.4:
            e["supersteps_p50"] = int(rng.integers(5, 40))
        if rng.random() < 0.2:
            e["mesh_devices"] = int(rng.choice([2, 8]))
        if rng.random() < 0.1:
            e["accelerator_unreachable"] = True
        out.append(e)
    return out


def _write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def _tool(module, argv, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", module] + argv, cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout, r.stderr


def _both(tmp_path, argv, files):
    """Run the JAX tool and the port's in their own directories holding
    the same `files`; returns ((rc, out, err), (rc, out, err), dirs)."""
    got = []
    for side, module in (("jax", "tools.bench_compare"),
                         ("torch", "ksched_tpu_torch.tools.bench_compare")):
        d = tmp_path / side
        d.mkdir()
        for name, rows in files.items():
            _write(d / name, rows)
        got.append(_tool(module, argv, d) + (d,))
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("tolerance", ["0.15", "0.05"])
def test_bench_compare_gate_equals_jax(tmp_path, seed, tolerance):
    (jrc, jout, jerr, _), (trc, tout, terr, _) = _both(
        tmp_path, ["gate", "traj.jsonl", "--tolerance", tolerance],
        {"traj.jsonl": _trajectory(seed)})
    assert (trc, tout, terr) == (jrc, jout, jerr)


def test_bench_compare_gate_fails_and_keeps_series_apart(tmp_path):
    """A card reading after a TPU one is its own series: no gate; a
    regressed card series fails with the JAX tool's text."""
    rows = [{"config": "a", "platform": "tpu", "p50_ms": 1.0, "commit": "x"},
            {"config": "a", "platform": "cuda", "p50_ms": 9.0, "commit": "y"},
            {"config": "b", "platform": "cuda", "p50_ms": 2.0, "commit": "y"},
            {"config": "b", "platform": "cuda", "p50_ms": 3.0, "commit": "z"}]
    (jrc, jout, jerr, _), (trc, tout, terr, _) = _both(
        tmp_path, ["gate", "traj.jsonl"], {"traj.jsonl": rows})
    assert (trc, tout, terr) == (jrc, jout, jerr)
    assert trc == 1 and "b [cuda]" in terr and "a [" not in tout


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_compare_show_equals_jax(tmp_path, seed):
    (jrc, jout, jerr, _), (trc, tout, terr, _) = _both(
        tmp_path, ["show", "traj.jsonl"], {"traj.jsonl": _trajectory(seed)})
    assert (trc, tout, terr) == (jrc, jout, jerr)


def _records():
    return [
        {"suite_stamp": True, "commit": "c", "platform": "cuda"},
        {"metric": "p50 ..., backend=device/cuda", "value": 4.5, "unit": "ms",
         "vs_baseline": 2.2, "config": "coco50k",
         "detail": {"supersteps_p50": 12, "supersteps_p99": 90, "supersteps_max": 400}},
        {"metric": "config gtrace12k FAILED", "value": None, "config": "gtrace12k"},
        {"metric": "p50 ..., backend=csr/cuda", "value": 240.0, "config": "churn",
         "detail": {"arms": {"device_resident": {"supersteps_p50": 10,
                                                 "h2d_delta_bytes_per_round": 40960},
                             "full_rebuild": {"p50_ms": 300.0}},
                    "p50_improvement_vs_full_rebuild": 0.2}},
        {"metric": "p50 ..., backend=sharded/cuda", "value": 700.0, "config": "gtrace100k",
         "detail": {"mesh_devices": 2, "supersteps_p50": 10}},
        {"metric": "p50 ..., backend=device/tpu", "value": 3.0, "config": "10kx1k",
         "accelerator_unreachable": True},
    ]


@pytest.mark.parametrize("extra", [[], ["--config", "renamed", "--note", "a note"]])
def test_bench_compare_append_equals_jax(tmp_path, extra):
    (jrc, jout, jerr, jd), (trc, tout, terr, td) = _both(
        tmp_path, ["append", "traj.jsonl", "--from-bench", "out.jsonl"] + extra,
        {"traj.jsonl": _trajectory(5, 4), "out.jsonl": _records()})
    assert (trc, tout, terr) == (jrc, jout, jerr)
    assert trc == 0 and "appended 4 entries" in tout and "skipping failed" in terr

    def rows(d):
        return [{k: v for k, v in json.loads(x).items() if k != "utc"}
                for x in (d / "traj.jsonl").read_text().splitlines()]

    assert rows(td) == rows(jd)
    assert [r["platform"] for r in rows(td)[4:]] == ["cuda", "cuda", "cuda", "cpu-fallback"]


def test_assemble_model_check_equals_jax(tmp_path, monkeypatch, capsys):
    """The JAX tool reads its three inputs from fixed paths and writes
    MODEL_CHECK_r05.json in the working directory: its `open` is pointed
    at this test's files."""
    import builtins

    from tools import assemble_model_check as jamc

    suite = tmp_path / "suite.jsonl"
    rng = np.random.default_rng(3)
    recs = [{"suite_stamp": True}]
    for config, full in (("coco50k-preempt", True), ("whare-hetero", False),
                         ("quincy10k-multiblock", False)):
        lm = {"fit": "lstsq", "fixed_ms": round(float(rng.uniform(1, 4)), 4),
              "per_superstep_us": round(float(rng.uniform(2, 9)), 4), "p99_ms": 8.5}
        d = {"latency_model": lm, "supersteps_p99": int(rng.integers(100, 3000))}
        if full:
            lm["per_superstep_us_full"] = round(float(rng.uniform(4, 12)), 4)
            d["supersteps_scoped_p99"] = int(rng.integers(100, 900))
        recs.append({"config": config, "detail": d})
    _write(suite, recs)
    paths = {}
    for flag in ("preempt", "whare", "multiblock"):
        p = tmp_path / f"mc_{flag}.json"
        p.write_text(json.dumps({
            "fit": {"kappa_measured_us": round(float(rng.uniform(2, 10)), 4),
                    "t_loop_ms": round(float(rng.uniform(0, 1)), 4)},
            "instances": [{"instance": 0, "replay_ss": int(rng.integers(10, 99))}],
            "inst_file": f"{flag}.npz"}))
        paths[f"/tmp/mc_{flag}.json"] = str(p)
    real_open = builtins.open
    monkeypatch.setattr(jamc, "open", lambda f, *a, **k: real_open(paths.get(f, f), *a, **k),
                        raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["assemble_model_check.py", str(suite)])
    jamc.main()
    want_lines = capsys.readouterr().out.splitlines()
    want = json.loads((tmp_path / "MODEL_CHECK_r05.json").read_text())
    lines = []
    got = tamc.assemble(str(suite), {c: paths[f"/tmp/mc_{f}.json"] for c, f, _w in tamc.JOBS},
                        log=lambda *a: lines.append(" ".join(str(x) for x in a)))
    assert lines == want_lines
    assert got["suite_artifact"] == want["suite_artifact"]
    for c, e in want["configs"].items():
        assert {k: v for k, v in got["configs"][c].items() if k != "what_was_timed"} == \
            {k: v for k, v in e.items() if k != "what_was_timed"}
    out = tmp_path / "mc_torch.json"
    assert tamc.main([str(suite), "--preempt", paths["/tmp/mc_preempt.json"],
                      "--whare", paths["/tmp/mc_whare.json"], "--multiblock",
                      paths["/tmp/mc_multiblock.json"], "--out", str(out)],
                     log=lambda *a: None) == 0
    assert json.loads(out.read_text())["configs"] == got["configs"]


def test_mega_bench_flows_equal_across_backends_and_jax():
    """A tiny graph (40 tasks on 4 machines): plain B3, CSR and ELL give
    one flow and objective, the JAX package's scan-CSR solve the same;
    the record's graph and supersteps equal the JAX tool's."""
    import __graft_entry__ as graft
    import jax.numpy as jnp
    from ksched_tpu.solver.jax_solver import _solve_mcmf, build_csr_plan
    from tools import mcmf_mega_bench as jmega

    problem = tmega.build_problem(num_machines=4, tasks=40)
    jprob = graft._build_problem(num_machines=4, tasks=40)
    for k in ("src", "dst", "cap", "cost", "excess"):
        assert np.array_equal(getattr(problem, k), getattr(jprob, k))
    fns = tmega.solve_fns(problem, 4096, tmega.KNOWN, "cpu")
    assert set(fns) == set(tmega.KNOWN)
    got = {name: fn() for name, fn in fns.items()}
    flows = {name: f.numpy() for name, (_s, f) in got.items()}
    cost = problem.cost.astype(np.int64)
    n = jprob.num_nodes
    plan = build_csr_plan(jprob.src.astype(np.int32), jprob.dst.astype(np.int32), n)
    out = _solve_mcmf(
        jnp.asarray(jprob.cap.astype(np.int32)),
        jnp.asarray(jprob.cost.astype(np.int32) * np.int32(n)),
        jnp.asarray(jprob.excess.astype(np.int32)), jnp.zeros(len(jprob.src), jnp.int32),
        jnp.asarray(np.int32(1)),
        *(jnp.asarray(x) for x in (plan.s_arc, plan.s_sign, plan.s_src, plan.s_dst,
                                   plan.s_segstart, plan.s_isstart, plan.inv_order,
                                   plan.node_first, plan.node_last, plan.node_nonempty)),
        alpha=8, max_supersteps=4096)
    jflow = np.asarray(out[0])
    for name in tmega.KNOWN:
        assert np.array_equal(flows[name], jflow), name
        assert int(np.sum(flows[name].astype(np.int64) * cost)) == int(
            np.sum(jflow.astype(np.int64) * cost))
        assert got[name][0] == int(out[2])
    want = jmega.run_bench(tasks=40, machines=4, solves=1, backends=("csr", "ell"))
    rec = tmega.run_bench(tasks=40, machines=4, solves=1, device="cpu")
    for k in ("nodes", "arcs", "entries", "solves"):
        assert rec["detail"][k] == want["detail"][k]
    for b in ("csr", "ell"):
        assert rec["detail"][b]["supersteps"] == want["detail"][b]["supersteps"]
    assert rec["detail"]["mega"]["supersteps"] == want["detail"]["csr"]["supersteps"]
    assert rec["detail"]["mega"]["mode"].startswith("plain")
    assert "UNMEASURED" in rec["detail"]["mega_vs_csr_speedup"]
    assert rec["metric"].endswith("backend=mega/cpu") and rec["detail"]["platform"] == "cpu"


#: (tail_repro config, rounds, threshold): two or three tails a capture
TAILS = [("whare", 3, 1), ("coco-preempt", 6, 300), ("quincy", 3, 1)]


@pytest.mark.parametrize("name,rounds,threshold", TAILS, ids=[t[0] for t in TAILS])
def test_model_check_chain_supersteps_equal_jax(tmp_path, name, rounds, threshold):
    """A captured tail (the port's tail_repro at the tool tests' cut
    configs, the JAX tool's npz keys) re-solved in a 2-rep chain: every
    rep's supersteps and the chain's total equal to the JAX tool's
    chain (plain transport, tiered, grouped two-stage)."""
    from tools import model_check as jmc

    dev, tasks, groups = small_config("torch", name)
    insts, _ss = ttail.capture_rounds(dev, tasks, rounds, threshold, groups=groups,
                                      log=lambda *a, **k: None)
    path = tmp_path / "insts.npz"
    np.savez_compressed(str(path), **ttail.instances_npz(dev, insts, groups is not None))
    data = np.load(str(path))
    assert int(data["n"]) >= 1
    total, per, conv = jmc.build_chain(data, 0, 2, 8, 1 << 17)(0)
    got = tmc.build_chain(data, 0, 2, 8, 1 << 17, "cpu")()
    assert got == (int(total), [int(x) for x in np.asarray(per)], bool(conv))
    assert got[2] and got[1][0] > 0


def test_model_check_record(tmp_path):
    """model_check's record on a whare capture: every instance, the fit
    when their supersteps differ, and the comparison against a suite
    record's slope."""
    dev, tasks, groups = small_config("torch", "whare")
    insts, _ss = ttail.capture_rounds(dev, tasks, 3, 1, groups=groups,
                                      log=lambda *a, **k: None)
    path = tmp_path / "insts.npz"
    np.savez_compressed(str(path), **ttail.instances_npz(dev, insts, False))
    suite = tmp_path / "suite.jsonl"
    _write(suite, [{"config": "whare-hetero", "detail": {"latency_model": {
        "per_superstep_us": 5.0}}}])
    lines = []
    assert tmc.main(["--inst", str(path), "--reps", "2", "--device", "cpu", "--suite-json",
                     str(suite), "--config", "whare-hetero"], log=lines.append) == 0
    out = json.loads(lines[0])
    assert out["platform"] == "cpu" and len(out["instances"]) == int(np.load(path)["n"])
    assert all(r["reps"] == 2 and r["total_ss"] == 2 * r["replay_ss"]
               for r in out["instances"])
    if out["fit"] is not None:
        assert out["comparison"]["kappa_model_us"] == 5.0


def test_coco_anatomy_supersteps_equal_bench(monkeypatch):
    """The four variants at 10 machines and 500 tasks, 4-round chunks:
    each variant's supersteps p50 and chunk count equal to bench.py's
    `_device_bench` at the JAX tool's arguments."""
    from ksched_tpu.costmodels import coco as jcoco_mod
    from ksched_tpu.costmodels.device_costs import coco_device_cost_fn as jcoco

    from torch_bench_reference import StableArgsort

    monkeypatch.setattr(jbench, "np", StableArgsort(jbench.np))
    M, T = 10, 500
    pen = np.random.default_rng(0).integers(0, 40, (M, 4)).astype(np.int64)
    got = tanat.run(device="cpu", tasks=T, machines=M, rounds=4, chunk=4)
    for name, slots, width in tanat.VARIANTS:
        rec = jbench._device_bench(
            tasks=T, machines=M, pus=4, jobs=20, churn=0.01, rounds=4, chunk=4,
            num_task_classes=4, class_cost_fn=jcoco(pen),
            unsched_cost=jcoco_mod.UNSCHEDULED_COST, ec_cost=0, supersteps=1 << 17,
            label=f"coco50k anatomy/{name}", slots=slots, decode_width=width)
        assert got[name]["supersteps_p50"] == rec["detail"]["supersteps_p50"], name
        assert len(got[name]["chunks_wall_ms"]) == len(rec["detail"]["chunks_wall_ms"])
    assert set(got["decomposition"]) == {"solve_plus_contention_ms",
                                         "decode_per_1024_width_ms",
                                         "decode_at_4096_ms_est", "residual_floor_ms_est"}


def test_csr_bench_and_primitives_records():
    rec = tcsr.run(solves=2, chunks=2, device="cpu", tasks=40, machines=4)
    assert rec["detail"]["solves_per_chunk"] == 2 and len(rec["detail"]["chunks_wall_ms"]) == 2
    assert rec["detail"]["supersteps_per_solve"] > 0 and rec["metric"].endswith("csr/cpu")
    rec = tcsr.run(solves=1, chunks=1, layout="ell", device="cpu", tasks=40, machines=4)
    assert rec["metric"].endswith("ell/cpu")
    out = tprim.run(reps=2, device="cpu", N=64, E=256, ES=64, W=8)
    assert out["platform"] == "cpu" and len(out["per_op_us"]) == 8
    assert all(v >= 0 for v in out["per_op_us"].values())
