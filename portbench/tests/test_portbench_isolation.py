"""What runs on the card imports neither JAX nor the JAX package, and
the reference imports nothing of the program. Top-level module names
are compared whole: `ksched_tpu_torch` begins with `ksched_tpu`."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

BANNED = {"jax", "jaxlib", "flax", "ksched_tpu", "bench", "__graft_entry__",
          "chip_smoke", "tests", "tools"}


def _imports(path):
    """(top-level absolute imports, relative imports as portbench
    module names) of one file."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(harness.ROOT).with_suffix("").parts[:-1]
    tops, rel = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join(base + tuple((node.module or "").split("."))).strip(".")
                rel.add(mod)
                rel |= {f"{mod}.{a.name}" for a in node.names}
            else:
                tops.add(node.module.split(".")[0])
                if node.module.startswith("portbench"):
                    rel.add(node.module)
    return tops, rel


def _sources():
    return sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_module_of_the_harness_imports_jax_or_the_jax_package(path):
    tops, _rel = _imports(path)
    assert not tops & BANNED, tops & BANNED


def test_the_reference_imports_nothing_of_the_program():
    seen, todo = set(), ["portbench.reference"]
    todo += [f"portbench.reference.{p.stem}"
             for p in (harness.HERE / "reference").glob("*.py")]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        base = harness.ROOT / mod.replace(".", "/")
        path = base.with_suffix(".py") if base.with_suffix(".py").exists() else base / "__init__.py"
        if not path.exists():
            continue
        tops, rel = _imports(path)
        assert "ksched_tpu_torch" not in tops and "ksched_tpu" not in tops, (mod, tops)
        assert tops <= {"numpy", "portbench", "__future__", "math"}, (mod, tops)
        todo += sorted(rel)
    assert "portbench.systems" not in {m.rsplit(".", 1)[0] for m in seen}


def test_a_run_loads_no_forbidden_module():
    code = ("import time, json; from portbench import harness; "
            "from portbench.tests.small import QUINCY, STEADY; "
            "harness.run_cell(harness.load_benchmark(), 'quincy10k-multiblock.steady', "
            "QUINCY, STEADY, 5, 0.5, False, 'cpu', time.perf_counter()); "
            "print(json.dumps(harness.forbidden_modules()))")
    got = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ksched_tpu_torch_x", sys)
    assert "ksched_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ksched_tpu.utils", sys)
    assert "ksched_tpu" in harness.forbidden_modules()
