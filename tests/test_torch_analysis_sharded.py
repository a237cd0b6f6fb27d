"""The sharded programs' contracts at D = 2 over gloo (one spawn of two
ranks for the file, ksched_tpu_torch/parallel/launch.py): every
(program, check) pair that needs ranks, the collective budget of the
slot-stable sharded solve equal to the JAX registry's
`sharded_slot_solve` (3 psum, 1 pmin, 2 pmax in a loop iteration; the
soltel ring adds loop psums), its warm variant on the same budget, and
the sharded layered solve's counts (5 psum, 2 pmax and 2 all_gather a
superstep, 2 pmin a tiered refinement wave)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_analysis_cases import SHARDED_PAIRS, pair_id  # noqa: E402

WORLD = 2

#: the sharded layered solve's collectives in its busiest iteration of
#: each loop kind (PERF.md §6: the JAX package's sharded transport)
LAYERED_SUPERSTEP = {"psum": 5, "pmax": 2, "all_gather": 2}
LAYERED_WAVE = {"pmin": 2}


@pytest.fixture(scope="module")
def ranks():
    from ksched_tpu_torch.parallel.launch import run_ranks

    return run_ranks("torch_analysis_cases:sharded_cases", WORLD, deadline_s=600)


@pytest.mark.parametrize("pair", SHARDED_PAIRS, ids=pair_id)
def test_sharded_program_contract(ranks, pair):
    key = f"{pair[0]}/{pair[1]}"
    for rank, res in enumerate(ranks):
        assert res["checks"][key] is None, f"rank {rank}: {res['checks'][key]}"


def test_slot_budget_equals_the_jax_registry(ranks):
    from ksched_tpu.analysis.program_registry import PROGRAMS as JAX

    budget = JAX["sharded_slot_solve"].collectives
    for res in ranks:
        got = res["sharded_slot_solve"]
        assert got["loop"] == dict(budget.loop)
        assert budget.knob_adds_loop_psum
        assert got["loop_on"]["psum"] > got["loop"]["psum"]
        assert {k: v for k, v in got["loop_on"].items() if k != "psum"} == \
            {k: v for k, v in got["loop"].items() if k != "psum"}
        assert got["iterations"]["superstep"] > 1 and got["iterations"]["sweep"] >= 1
        # the warm variant shares the site and its budget
        assert res["sharded_slot_solve_warmp"]["loop"] == dict(budget.loop)
        assert res["sharded_solve"]["loop"] == dict(budget.loop)
    assert ranks[0]["sharded_slot_solve"] == ranks[1]["sharded_slot_solve"]


def test_sharded_layered_counts(ranks):
    for res in ranks:
        plain, tiered = res["layered"], res["layered_tiered"]
        assert plain["converged"] and tiered["converged"]
        assert plain["loop"] == {"superstep": LAYERED_SUPERSTEP}
        assert tiered["loop"]["superstep"] == LAYERED_SUPERSTEP
        assert tiered["loop"]["wave"] == LAYERED_WAVE
        assert tiered["iterations"]["wave"] >= 1
