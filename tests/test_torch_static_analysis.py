"""The port's Level-1 lint and CLI (ksched_tpu_torch/analysis/): every
rule fires on a bad snippet, the waivers and their audits, the baseline
multiset, the CLI's exit codes and its coverage line; the rules the port
shares with the JAX package's linter give the same (rule, line) pairs
and fingerprints on the same snippets; and the port's own tree is
lint-clean with every device-program site covered."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from ksched_tpu_torch.analysis import (
    PROGRAMS,
    RULES,
    SITE_NAMES,
    fingerprint,
    lint_paths,
    lint_source,
    load_baseline,
    parse_directive,
    program_coverage,
    split_by_baseline,
    write_baseline,
)
from ksched_tpu_torch.analysis.__main__ import main as cli_main

ROOT = Path(__file__).resolve().parents[1]
LIB = "ksched_tpu_torch/mod.py"  # a library path: every rule applies


def lint(src, path=LIB, rules=None):
    return lint_source(path, textwrap.dedent(src), rules=rules)


def rules_lines(vs):
    return sorted((v.rule, v.line) for v in vs)


#: one snippet a rule that it must flag (a device module where it matters)
BAD = {
    "dtype64": "import torch\nx = torch.zeros(3, dtype=torch.int64)\n",
    "implicit-dtype": "import torch\nx = torch.arange(4)\n",
    "int32-reduce": "import torch\ndef f(t):\n    return t.sum()\n",
    "foreign-import": "import jax.numpy as jnp\n",
    "mutable-default": "def f(x=[]):\n    return x\n",
    "bare-except": "try:\n    pass\nexcept:\n    pass\n",
    "raw-print": "print('hi')\n",
    "unregistered-program": "def f(lib):\n    return lib.ksched_thing_solve(1)\n",
    "stale-waiver": "x = 1  # kschedlint: disable=bare-except -- nothing here\n",
    "bad-waiver": "x = 1  # kschedlint: disable=bare-excpet -- typo\n",
}


def test_every_rule_has_a_bad_snippet():
    assert set(BAD) == set(RULES)


@pytest.mark.parametrize("rule", sorted(BAD))
def test_rule_fires_on_its_snippet(rule):
    got = lint(BAD[rule])
    assert rule in {v.rule for v in got}, got


def test_syntax_error_is_one_violation():
    got = lint("def f(:\n    pass\n")
    assert [v.rule for v in got] == ["syntax-error"]


@pytest.mark.parametrize("src,want", [
    ("import torch\nx = torch.zeros(3, dtype=torch.long)\n", [("dtype64", 2)]),
    ("import torch\ndef f(t):\n    return t.long()\n", [("dtype64", 3)]),
    ("import torch\ndef f(t):\n    return t.double()\n", [("dtype64", 3)]),
    ("import torch\nimport numpy as np\ny = np.zeros(2, np.int64)\n", [("dtype64", 3)]),
    ("import torch\nimport numpy as np\ny = np.zeros(2).astype('float64')\n", [("dtype64", 3)]),
    # numpy alone is a host module: dtype64 does not apply
    ("import numpy as np\ny = np.zeros(2, np.int64)\n", []),
    # outside the library (a script) it does not apply either
])
def test_dtype64_forms(src, want):
    assert rules_lines(lint(src, rules=["dtype64"])) == want


def test_dtype64_is_library_only():
    assert lint(BAD["dtype64"], path="chip_smoke.py", rules=["dtype64"]) == []


@pytest.mark.parametrize("src,n", [
    ("import torch\nx = torch.zeros(3, dtype=torch.int32)\n", 0),
    ("import torch\nx = torch.full((2,), 7)\n", 1),
    ("import torch\nx = torch.tensor([1, 2])\n", 1),
    ("import torch\nkw = {}\nx = torch.ones(3, **kw)\n", 0),
    ("import torch\nx = torch.zeros_like(torch.ones(1, dtype=torch.int32))\n", 0),
])
def test_implicit_dtype_forms(src, n):
    assert len(lint(src, rules=["implicit-dtype"])) == n


@pytest.mark.parametrize("src,n", [
    ("import torch\ndef f(t):\n    return torch.cumsum(t, 0)\n", 1),
    ("import torch\ndef f(t):\n    return torch.cumsum(t, 0, dtype=torch.int32)\n", 0),
    ("import torch\ndef f(t):\n    return t.sum(1, dtype=torch.int32) + t.prod()\n", 1),
    ("import torch\nimport numpy as np\ndef f(a):\n    return np.sum(a)\n", 0),
    ("def f(t):\n    return t.sum()\n", 0),  # no torch import: a host module
])
def test_int32_reduce_forms(src, n):
    assert len(lint(src, rules=["int32-reduce"])) == n


@pytest.mark.parametrize("src", [
    "import jax\n", "from jax import numpy\n", "import jaxlib\n",
    "from ksched_tpu.graph import flowgraph\n", "import ksched_tpu.ops\n",
    "import importlib\nm = importlib.import_module('ksched_tpu.ops')\n",
])
def test_foreign_import_forms(src):
    assert [v.rule for v in lint(src, rules=["foreign-import"])] == ["foreign-import"]


def test_foreign_import_allows_the_port_itself():
    src = "import ksched_tpu_torch\nfrom ksched_tpu_torch.ops import mcmf\nfrom .x import y\n"
    assert lint(src, rules=["foreign-import"]) == []


# -- waivers ----------------------------------------------------------------


@pytest.mark.parametrize("directive", [
    "host-only (host math)", "index-only (a gather index)",
    "disable=dtype64 -- why",
])
def test_dtype64_waivers(directive):
    src = f"import torch\ndef f(t):\n    return t.long()  # kschedlint: {directive}\n"
    assert lint(src) == []


def test_host_only_silences_only_dtype64():
    src = "import torch\nx = torch.arange(3)  # kschedlint: host-only (why)\n"
    assert rules_lines(lint(src)) == [("implicit-dtype", 2), ("stale-waiver", 2)]


@pytest.mark.parametrize("directive", ["host-only (x)", "index-only (x)",
                                       "disable=raw-print -- x", "program=csr_solve"])
def test_stale_waivers(directive):
    src = f"import torch\nx = 1  # kschedlint: {directive}\n"
    assert rules_lines(lint(src)) == [("stale-waiver", 2)]


@pytest.mark.parametrize("directive,n", [
    ("hostonly", 1), ("disable=", 1), ("disable=no-such-rule -- x", 1),
    ("disable=unregistered-program", 1), ("program=", 1),
])
def test_bad_waivers(directive, n):
    src = f"x = 1  # kschedlint: {directive}\n"
    assert [v.rule for v in lint(src)].count("bad-waiver") == n


def test_program_sites():
    src = textwrap.dedent("""\
        import torch.distributed as dist


        def solve(a):  # kschedlint: program=csr_solve
            return a


        def launch(lib):
            lib.ksched_x_solve(1)  # kschedlint: program=mega_solve
            lib.ksched_x_probe(1)  # kschedlint: disable=unregistered-program -- a timing probe
            dist.all_reduce(1)


        def annotated_typo(a):  # kschedlint: program=csr_solv
            return a
        """)
    got = lint_source(LIB, src, rules=["unregistered-program"])
    assert rules_lines(got) == [("unregistered-program", 11), ("unregistered-program", 14)]
    # the waived probe is not flagged and its waiver is not stale
    assert "stale-waiver" not in {v.rule for v in lint_source(LIB, src)}


# -- the baseline ----------------------------------------------------------


def test_baseline_multiset_and_prune(tmp_path):
    src = "def f(a=[]):\n    pass\n\n\ndef g(a=[]):\n    pass\n"
    vs = lint(src)
    assert [v.rule for v in vs] == ["mutable-default"] * 2
    path = tmp_path / "baseline.json"
    assert write_baseline(str(path), vs[:1]) == 1
    base = load_baseline(str(path))
    new, old, stale = split_by_baseline(vs, base)
    # the two lines differ, so one entry waives exactly one of them
    assert (len(new), len(old), sum(stale.values())) == (1, 1, 0)
    dup = lint("def f(a=[]):\n    pass\n\n\ndef f(a=[]):\n    pass\n")
    write_baseline(str(path), dup[:1])
    new, old, _ = split_by_baseline(dup, load_baseline(str(path)))
    assert (len(new), len(old)) == (1, 1)  # one entry waives one occurrence
    _, _, stale = split_by_baseline([], load_baseline(str(path)))
    assert sum(stale.values()) == 1
    assert load_baseline(str(tmp_path / "missing.json")) == Counter()


def test_the_port_baseline_is_empty():
    data = json.loads((ROOT / "ksched_tpu_torch/analysis/baseline.json").read_text())
    assert data["violations"] == []


# -- the CLI ----------------------------------------------------------------


def _tree(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(tmp_path)


def test_cli_exit_codes(tmp_path, capsys):
    root = _tree(tmp_path, {"ksched_tpu_torch/a.py": "x = 1\n", "chip_smoke.py": "y = 2\n",
                            "ksched_tpu_torch/analysis/__init__.py": ""})
    assert cli_main(["--root", root]) == 0
    (tmp_path / "ksched_tpu_torch/b.py").write_text("def f(a={}):\n    return a\n")
    assert cli_main(["--root", root]) == 1
    assert "mutable-default" in capsys.readouterr().out
    assert cli_main(["--root", root, "--write-baseline"]) == 0
    assert cli_main(["--root", root]) == 0
    (tmp_path / "ksched_tpu_torch/b.py").write_text("def f(a=None):\n    return a\n")
    assert cli_main(["--root", root]) == 1  # a stale baseline entry
    assert cli_main(["--root", root, "--prune-baseline"]) == 0
    assert cli_main(["--root", root]) == 0
    assert cli_main(["--root", root, "--rules", "no-such-rule"]) == 2
    assert cli_main(["--root", root, "no/such/path.py"]) == 2
    assert cli_main(["--root", root, "--no-baseline", "--rules", "bare-except"]) == 0
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in RULES)


def test_cli_json_and_coverage_on_the_port(capsys):
    assert cli_main(["--json", "--coverage"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] and payload["new"] == [] and payload["stale_baseline"] == []
    cov = payload["coverage"]
    assert cov["programs_registered"] == 23 == len(PROGRAMS)
    assert cov["unaudited"] == [] and cov["unannotated_registered"] == []
    assert cov["summary"].startswith("kschedlint-torch L3: 23 programs registered / ")
    assert cov["summary"].endswith(" waived / 0 unaudited")


def test_module_entry_point_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    got = subprocess.run([sys.executable, "-m", "ksched_tpu_torch.analysis", "--coverage"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stdout + got.stderr
    assert "23 programs registered" in got.stdout and "/ 0 unaudited" in got.stdout


# -- the port's tree --------------------------------------------------------


def test_the_port_is_lint_clean():
    assert [v.render() for v in lint_paths(["ksched_tpu_torch", "chip_smoke.py"],
                                           repo_root=str(ROOT))] == []


def test_the_lint_covers_the_tools():
    """The operator tools and the device soak are library files the lint
    and the coverage sweep read (device modules where they import torch;
    the shard smoke's ranks hand the device to ShardMesh and touch no
    tensor themselves)."""
    from ksched_tpu_torch.analysis.ast_rules import build_context, iter_py_files

    files = set(iter_py_files(["ksched_tpu_torch"], repo_root=str(ROOT)))
    tools = {f"ksched_tpu_torch/tools/{n}.py" for n in (
        "__init__", "tail_repro", "superstep_trace", "obs_report", "profile_round",
        "shard_smoke")} | {"ksched_tpu_torch/drivers/soak.py"}
    assert tools <= files
    device = {rel for rel in tools
              if build_context(rel, (ROOT / rel).read_text()).device_bound}
    assert device == {"ksched_tpu_torch/tools/tail_repro.py",
                      "ksched_tpu_torch/tools/profile_round.py"}


def test_the_port_coverage_is_total():
    cov = program_coverage(["ksched_tpu_torch"], repo_root=str(ROOT))
    assert cov["unaudited"] == [] and cov["unannotated_registered"] == []
    assert {e["program"] for e in cov["annotated"]} == set(SITE_NAMES)
    kinds = Counter(e["kind"] for e in cov["annotated"] + cov["waived"])
    # the three kernels' launches and the one collective are swept
    assert kinds["launch"] >= 3 and kinds["collective"] >= 1
    launches = {(e["path"], e["program"]) for e in cov["annotated"] if e["kind"] == "launch"}
    assert launches == {("ksched_tpu_torch/ops/mcmf.py", "mega_solve"),
                        ("ksched_tpu_torch/ops/transport.py", "layered_solve")}


# -- held against the JAX package's linter ----------------------------------

#: snippets for the rules both linters share, at a path outside either library
SHARED = {
    "mutable-default": "def f(a=[], b={}, c=set()):\n    return a\n\n\nf2 = lambda x=[]: x\n",
    "bare-except": "try:\n    x = 1\nexcept:\n    x = 2\ntry:\n    pass\nexcept ValueError:\n    pass\n",
    "stale-waiver": "x = 1  # kschedlint: disable=bare-except -- nothing\ny = 2\n",
    "bad-waiver": ("a = 1  # kschedlint: nonsense\n"
                   "b = 2  # kschedlint: disable=bare-excpet -- typo\n"
                   "c = 3  # kschedlint: disable=\n"
                   "d = 4  # kschedlint: disable=unregistered-program\n"),
    "syntax-error": "def f(:\n    pass\n",
    "mixed": ("def g(x={}):\n    try:\n        return x\n    except:  # kschedlint: "
              "disable=bare-except -- teardown\n        return None\n"),
}
SHARED_RULES = ("mutable-default", "bare-except", "stale-waiver", "bad-waiver", "syntax-error")


def _jax_lint():
    from ksched_tpu.analysis import ast_rules as jax_rules

    return jax_rules


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rules_match_the_jax_linter(name):
    jax_rules = _jax_lint()
    src = SHARED[name]
    port = [v for v in lint_source("snippet.py", src) if v.rule in SHARED_RULES]
    ref = [v for v in jax_rules.lint_source("snippet.py", src) if v.rule in SHARED_RULES]
    assert rules_lines(port) == rules_lines(ref)
    assert sorted(fingerprint(v)["hash"] for v in port) == \
        sorted(fingerprint(v)["hash"] for v in ref)


def test_raw_print_matches_the_jax_linter():
    jax_rules = _jax_lint()
    src = "def f():\n    print('x')\n\n\nprint(1)\n"
    port = lint_source("ksched_tpu_torch/m.py", src, rules=["raw-print"])
    ref = jax_rules.lint_source("ksched_tpu/m.py", src, rules=["raw-print"])
    assert rules_lines(port) == rules_lines(ref) == [("raw-print", 2), ("raw-print", 5)]
    same_path = [dataclasses.replace(v, path="m.py") for v in port + ref]
    assert fingerprint(same_path[0]) == fingerprint(same_path[2])
    for cli in ("ksched_tpu_torch/cli.py", "ksched_tpu_torch/analysis/__main__.py"):
        assert lint_source(cli, src, rules=["raw-print"]) == []


@pytest.mark.parametrize("comment", [
    "kschedlint: host-only (why)", "kschedlint: host-only",
    "kschedlint: disable=bare-except,raw-print -- why",
    "kschedlint: disable=raw-print (why)", "kschedlint: disable=",
    "kschedlint: program=csr_solve", "kschedlint: program=csr_solve -- variant",
    "kschedlint: program=", "kschedlint: whatever", "no directive here",
    "note; kschedlint: host-only (merged into a comment)",
])
def test_directive_parsing_matches_the_jax_linter(comment):
    ref = _jax_lint().parse_directive(7, comment)
    got = parse_directive(7, comment)
    assert (got is None) == (ref is None)
    if got is not None:
        assert (got.kind, got.rules, got.program, got.has_rationale, got.text) == \
            (ref.kind, ref.rules, ref.program, ref.has_rationale, ref.text)


def test_index_only_is_the_ports_own_directive():
    assert parse_directive(1, "kschedlint: index-only (why)").kind == "index-only"
    assert _jax_lint().parse_directive(1, "kschedlint: index-only (why)").kind == "unknown"


def test_baseline_fingerprints_match_the_jax_package():
    from ksched_tpu.analysis import baseline as jax_baseline

    src = SHARED["mutable-default"]
    port = lint_source("snippet.py", src)
    ref = _jax_lint().lint_source("snippet.py", src)
    assert [fingerprint(v) for v in port] == [jax_baseline.fingerprint(v) for v in ref]
