"""The port's program registry (ksched_tpu_torch/analysis/) against the
JAX package's: the same 23 programs under the same names and kinds, the
same 18 sites; every backend make_backend builds is covered; every
(program, check) pair the engine applies passes on the CPU (this file
holds most of them: tests/test_torch_analysis_solves.py the ELL and
dense solves', tests/test_torch_analysis_sharded.py the ones that need
ranks); and every check has a seeded negative that fails with the
program's name in its message."""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_analysis_cases import (  # noqa: E402
    ALL_PAIRS,
    REGISTRY_PAIRS,
    SHARDED_PAIRS,
    SOLVE_PAIRS,
    pair_id,
)

from ksched_tpu_torch.analysis import engine, op_contracts  # noqa: E402
from ksched_tpu_torch.analysis import program_registry as reg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: differences between the two registries' names and kinds, with the
#: reason for each (none: the port registers every JAX program as it is)
DIFFERENCES = {}

#: what each backend make_backend builds runs on the device, or why it
#: runs no registered program
BACKENDS = {
    "jax": "csr_solve",
    "ell": "ell_solve",
    "mega": "mega_solve",
    "layered": "layered_solve",
    "sharded": "sharded_slot_solve",
    "auto": ("layered_solve", "mega_solve", "csr_solve", "sharded_slot_solve"),
    "native": None,  # the host C++ solver (solver/native.py), no device program
    "ref": None,  # the numpy successive-shortest-path oracle (solver/cpu_ref.py)
}


def _jax_registry():
    from ksched_tpu.analysis import program_registry as jax_reg

    return jax_reg


def test_names_and_kinds_equal_the_jax_registry():
    jax = {n: s.kind for n, s in _jax_registry().PROGRAMS.items()}
    port = {n: s.kind for n, s in reg.PROGRAMS.items()}
    differ = {n for n in set(jax) | set(port) if jax.get(n) != port.get(n)}
    assert differ == set(DIFFERENCES)
    assert len(port) == 23


def test_sites_equal_the_jax_registry():
    jax = _jax_registry()
    assert reg.SITE_NAMES == jax.SITE_NAMES and len(reg.SITE_NAMES) == 18
    for name, spec in reg.PROGRAMS.items():
        assert spec.site_name == jax.PROGRAMS[name].site_name, name
        assert spec.module.startswith("ksched_tpu_torch."), name


def test_hash_stability_classes_follow_the_jax_registry():
    jax = _jax_registry().PROGRAMS
    for name, spec in reg.PROGRAMS.items():
        mine = spec.hash_stability.kind if spec.hash_stability else None
        theirs = jax[name].hash_stability.kind if jax[name].hash_stability else None
        assert mine == theirs, name


def test_collective_budgets_follow_the_jax_registry():
    jax = _jax_registry().PROGRAMS
    slot = reg.PROGRAMS["sharded_slot_solve"].collectives
    assert dict(slot.loop) == dict(jax["sharded_slot_solve"].collectives.loop)
    assert slot.knob_adds_loop_psum == jax["sharded_slot_solve"].collectives.knob_adds_loop_psum
    for name, spec in reg.PROGRAMS.items():
        if spec.ranks == 0 and spec.collectives is not None:
            assert set(spec.collectives.forbidden) == {"psum", "pmin", "pmax", "all_gather"}


def _make_backend_names():
    tree = ast.parse((ROOT / "ksched_tpu_torch/solver/select.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_backend")
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) \
                and node.left.id == "name":
            for c in node.comparators:
                if isinstance(c, ast.Constant):
                    names.add(c.value)
    return names


def test_make_backend_names_are_covered():
    names = _make_backend_names()
    assert names == set(BACKENDS)
    for target in BACKENDS.values():
        for program in (target,) if isinstance(target, str) else (target or ()):
            assert program in reg.PROGRAMS


def test_kernels_are_registered_with_their_programs():
    for name, k in reg.KERNELS.items():
        assert (ROOT / k.source).is_file()
        path, line = k.replaces.split(":")
        assert (ROOT / path).read_text().splitlines()[int(line) - 1].startswith("def _")
        assert name in reg.PROGRAMS[k.program].kernels
        assert k.resources and all(len(r) == 5 for r in k.resources)
    assert sorted(reg.KERNELS) == ["mcmf", "transport", "transport_tiered"]


def test_declare_programs_checks_names_eagerly():
    with pytest.raises(ValueError, match="unregistered program"):
        reg.declare_programs("some.module", "csr_solve", "no_such_program")


def test_the_registry_and_cli_need_no_torch():
    code = ("import sys\nsys.modules['torch'] = None\nsys.modules['numpy'] = None\n"
            "from ksched_tpu_torch.analysis.__main__ import main\n"
            "from ksched_tpu_torch.analysis.program_registry import PROGRAMS\n"
            "assert len(PROGRAMS) == 23\nsys.exit(main(['--coverage']))\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert got.returncode == 0, got.stderr


def test_the_pairs_cover_every_applicable_check():
    assert sorted(REGISTRY_PAIRS + SOLVE_PAIRS + SHARDED_PAIRS) == sorted(ALL_PAIRS)
    assert not set(REGISTRY_PAIRS) & set(SOLVE_PAIRS)
    assert {n for n, _ in ALL_PAIRS} == set(reg.PROGRAMS)


@pytest.mark.parametrize("pair", REGISTRY_PAIRS, ids=pair_id)
def test_program_contract(pair):
    name, check = pair
    engine.CHECKS[check](reg.PROGRAMS[name])


def test_plain_mega_route_on_the_cpu_is_its_plain_version():
    """On a CPU tensor `mcmf_loop` runs `mcmf_loop_plain`: the same
    recorded program as the registered tracer's."""
    args, R, L = op_contracts._mega_args(32, 128, 0, "cpu")
    from ksched_tpu_torch.ops import mcmf

    rec = op_contracts.record(lambda: mcmf.mcmf_loop(*args, R, L, max_supersteps=4096))
    assert rec.trace_hash() == reg.PROGRAMS["mega_solve"].telemetry_off_hash


def test_loop_marks_leave_an_unrecorded_run_alone():
    """With no recorder a mark is a call that returns: the same results,
    and nothing attached."""
    from ksched_tpu_torch.analysis import marks

    assert marks.RECORDERS == []
    a = op_contracts.trace_csr(20, 100).outputs
    n, m = op_contracts.bucketed_sizes(20, 100)
    cap, cost, supply, flow0, eps, plan = op_contracts._csr_args(n, m, 0, "cpu")
    from ksched_tpu_torch.solver import csr_solver

    b = csr_solver._solve_mcmf(cap, cost, supply, flow0, eps, *plan, max_supersteps=4096)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert marks.RECORDERS == []


# -- seeded negatives: every check fails, naming the program ---------------


@pytest.fixture
def fresh():
    engine.clear_cache()
    yield
    engine.clear_cache()


def _seg_sum_with(monkeypatch, extra):
    from ksched_tpu_torch.solver import csr_solver

    orig = csr_solver._seg_sum

    def seg_sum(vals, *a):
        return extra(orig(vals, *a))

    monkeypatch.setattr(csr_solver, "_seg_sum", seg_sum)


def neg_forced_long(mp):
    _seg_sum_with(mp, lambda v: v.long().to(torch.int32))
    return "csr_solve", "contracts", "int64 calls"


def neg_undeclared_index_put(mp):
    def write(v):
        out = v.clone()
        idx = torch.zeros(1, dtype=torch.int32, device=v.device)
        out[idx] = v[idx]
        return out

    _seg_sum_with(mp, write)
    return "csr_solve", "contracts", "not declared permutations"


def neg_host_read_in_loop(mp):
    def read(v):
        bool(v.any())
        return v

    _seg_sum_with(mp, read)
    return "csr_solve", "contracts", "host reads a superstep"


def neg_trace_differs(mp):
    _seg_sum_with(mp, lambda v: v + 0)
    return "csr_solve", "hash_pin", "trace hash"


def neg_leaked_raw_size(mp):
    from ksched_tpu_torch.graph import device_export

    mp.setattr(device_export, "pad_record_count", lambda k: max(k, 1))
    return "delta_apply", "stability", "hash split inside one bucket"


def neg_dead_knob(mp):
    orig = op_contracts.trace_csr

    @functools.wraps(orig)
    def trace(n_raw, m_raw, seed=0, telemetry_cap=0, device="cpu", slot_stable=False):
        return orig(n_raw, m_raw, seed, 0, device, slot_stable)

    mp.setattr(op_contracts, "trace_csr", trace)
    return "csr_solve", "telemetry_knob", "knob is dead"


def neg_vacuous_variant(mp):
    orig = op_contracts.trace_csr_warmp

    @functools.wraps(orig)
    def trace(n_raw, m_raw, seed=0, telemetry_cap=0, slot_stable=False, device="cpu"):
        return op_contracts.trace_csr(n_raw, m_raw, seed, telemetry_cap, device)

    mp.setattr(op_contracts, "trace_csr_warmp", trace)
    return "csr_solve_warmp", "distinct", "variant is vacuous"


def neg_out_of_place_apply(mp):
    from ksched_tpu_torch.graph import device_export

    orig = device_export.delta_apply

    def apply(excess, src, dst, cap, cost, arc_rec, node_rec):
        return orig(excess, src, dst, cap.clone(), cost, arc_rec, node_rec)

    mp.setattr(device_export, "delta_apply", apply)
    return "delta_apply", "inplace", "NEW tensor"


def neg_live_set_constant(mp):
    from ksched_tpu_torch.ops import mcmf

    mp.setattr(mcmf, "MCMF_SCRATCH_TABLES", mcmf.MCMF_SCRATCH_TABLES + 1)
    return "mega_solve", "vmem_gate", "drifted"


def neg_undeclared_owner(mp):
    module = reg.PROGRAMS["plan_apply"].module
    mp.setitem(reg.DECLARED, module, set())
    return "plan_apply", "declared", "does not declare_programs"


def neg_vacuous_exemption(mp):
    from ksched_tpu_torch.runtime import integrity

    mp.setattr(integrity, "corrupt_flip", lambda buf, idx, bit: buf.clone())
    return "corrupt_flip", "contracts", "VACUOUS"


NEGATIVES = [neg_forced_long, neg_undeclared_index_put, neg_host_read_in_loop,
             neg_trace_differs, neg_leaked_raw_size, neg_dead_knob, neg_vacuous_variant,
             neg_out_of_place_apply, neg_live_set_constant, neg_undeclared_owner,
             neg_vacuous_exemption]


def test_every_check_has_a_seeded_negative():
    seen = set()
    for neg in NEGATIVES:
        with pytest.MonkeyPatch.context() as mp:
            seen.add(neg(mp)[1])
    assert seen == set(engine.CHECKS)


@pytest.mark.parametrize("negative", NEGATIVES, ids=lambda f: f.__name__[4:])
def test_seeded_negative_fails_naming_the_program(negative, monkeypatch, fresh):
    name, check, words = negative(monkeypatch)
    with pytest.raises(engine.ContractError) as err:
        engine.CHECKS[check](reg.PROGRAMS[name])
    assert f"program {name!r}" in str(err.value)
    assert words in str(err.value)
