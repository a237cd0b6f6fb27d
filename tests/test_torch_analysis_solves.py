"""The registry's (program, check) pairs of the ELL and dense transport
solves on the CPU (ksched_tpu_torch/analysis/engine.py): their plain
loops recorded at the JAX registry's calls, the hash pins, pow2-bucket
stability over `pad_geometry`'s buckets and the telemetry knob. The
other pairs are in tests/test_torch_program_registry.py and
tests/test_torch_analysis_sharded.py."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_analysis_cases import SOLVE_PAIRS, pair_id  # noqa: E402

from ksched_tpu_torch.analysis import engine, op_contracts  # noqa: E402
from ksched_tpu_torch.analysis.program_registry import PROGRAMS  # noqa: E402


@pytest.mark.parametrize("pair", SOLVE_PAIRS, ids=pair_id)
def test_program_contract(pair):
    name, check = pair
    engine.CHECKS[check](PROGRAMS[name])


def test_folded_hash_does_not_count_supersteps():
    """Two problems of one bucket that take different superstep counts
    record the same folded trace: a loop body counts once."""
    a = op_contracts.trace_layered(4, 100, seed=0)
    b = op_contracts.trace_layered(4, 100, seed=1)
    assert a.report().loop_iterations != b.report().loop_iterations
    assert a.trace_hash() == b.trace_hash()


def test_tiered_plain_loop_holds_the_layered_contract():
    rep = op_contracts.trace_layered(4, 100, tiered=True).report()
    assert rep.reads_by_kind == {"superstep": {1}} and rep.reads_once == 0
    assert not rep.wide and not rep.double_values and not rep.scatters
