"""The port stands alone: no module of ksched_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package; the port runs Scenario
W(20, 200) on the CPU in a process where importing either fails; and
asking for the card where there is none raises instead of carrying on
on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ksched_tpu", "tools", "bench", "__graft_entry__")


#: modules the port must hold (the cost models, DIMACS and tenancy; the
#: multi-device rung; the static-analysis suite; the operator tools; the
#: bench and the tools that read it)
REQUIRED = ("costmodels/simple.py", "costmodels/net.py", "costmodels/coco.py",
            "graph/dimacs.py", "tenancy/__init__.py", "tenancy/batch.py",
            "tenancy/manager.py", "tenancy/service.py", "drivers/multitenant.py",
            "parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_solver.py",
            "parallel/sharded_transport.py", "parallel/whatif.py", "parallel/launch.py",
            "drivers/sharded_scale.py", "drivers/parallel_scenarios.py",
            "analysis/__init__.py", "analysis/__main__.py", "analysis/ast_rules.py",
            "analysis/baseline.py", "analysis/engine.py", "analysis/marks.py",
            "analysis/op_contracts.py", "analysis/program_registry.py",
            "drivers/soak.py", "tools/__init__.py", "tools/tail_repro.py",
            "tools/superstep_trace.py", "tools/obs_report.py", "tools/profile_round.py",
            "tools/shard_smoke.py", "bench.py", "tools/coco_anatomy.py",
            "tools/mega_bench.py", "tools/csr_bench.py", "tools/primitives_bench.py",
            "tools/model_check.py", "tools/assemble_model_check.py",
            "tools/bench_compare.py")


def _port_sources():
    files = sorted((ROOT / "ksched_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("rel", REQUIRED)
def test_port_holds_the_module(rel):
    assert (ROOT / "ksched_tpu_torch" / rel).is_file()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


_SCRIPT = """
import json, sys
for name in ("jax", "jaxlib", "ksched_tpu"):
    sys.modules[name] = None  # any import of these now fails
from ksched_tpu_torch.drivers import whare_mixed_rounds
from ksched_tpu_torch.solver.select import make_backend
backend = make_backend("auto", device="cpu")
rows = []
for r, sched, placed in whare_mixed_rounds(20, 200, backend):
    rows.append([placed, backend.last_path, backend.last_supersteps,
                 sched.solver.last_result.objective])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
             and sys.modules[m] is not None)
print(json.dumps({"rounds": rows, "jax_loaded": bad}))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["jax_loaded"] == []
    assert got["rounds"] == [
        [200, "dense", 0, 0], [50, "dense", 84, 0],
        [50, "dense", 3207, 166], [20, "dense", 170, 76756],
    ]


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    from ksched_tpu_torch.drivers import build_cluster
    from ksched_tpu_torch.solver.graph_collapse import AutoSolver
    from ksched_tpu_torch.solver.layered import LayeredTransportSolver
    from ksched_tpu_torch.solver.select import make_backend

    from ksched_tpu_torch.solver.csr_solver import CsrSolver
    from ksched_tpu_torch.solver.mega_solver import MegaSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "jax", "mega", "layered", "ref"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_backend(name)
    for entry in (AutoSolver, CsrSolver, MegaSolver):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(None) if entry is AutoSolver else entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LayeredTransportSolver()
    # the scheduler's default backend is make_backend("auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cluster(num_machines=2)
    from ksched_tpu_torch.tenancy import LaneSolver, MultiTenantService, StackedBatcher

    for entry in (MultiTenantService, StackedBatcher):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LaneSolver(StackedBatcher(device="cpu"))
    # the CPU stays available on request
    assert make_backend("auto", device="cpu").device.type == "cpu"
    assert MultiTenantService(device="cpu").device.type == "cpu"
    assert make_backend("mega", device="cpu").device.type == "cpu"


#: the operator tools' entry points, each run on the card by default
TOOL_ENTRIES = {
    "soak": ("ksched_tpu_torch.drivers.soak", ["--rounds", "8"]),
    "soak-chaos": ("ksched_tpu_torch.drivers.soak", ["--chaos", "--rounds", "8"]),
    "tail_repro": ("ksched_tpu_torch.tools.tail_repro", ["capture", "--rounds", "1"]),
    "profile_round": ("ksched_tpu_torch.tools.profile_round", ["--trace-out", ""]),
    "shard_smoke": ("ksched_tpu_torch.tools.shard_smoke", []),
    "bench": ("ksched_tpu_torch.bench", ["--small"]),
    "bench-config": ("ksched_tpu_torch.bench", ["--config", "mcmf-mega"]),
    "coco_anatomy": ("ksched_tpu_torch.tools.coco_anatomy", []),
    "mega_bench": ("ksched_tpu_torch.tools.mega_bench", []),
    "csr_bench": ("ksched_tpu_torch.tools.csr_bench", []),
    "primitives_bench": ("ksched_tpu_torch.tools.primitives_bench", []),
    "model_check": ("ksched_tpu_torch.tools.model_check", ["--inst", "missing.npz"]),
}


@pytest.mark.parametrize("tool", list(TOOL_ENTRIES))
def test_tool_entry_points_raise_without_a_card(monkeypatch, tool):
    import importlib

    mod_name, argv = TOOL_ENTRIES[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(mod_name).main(argv)
