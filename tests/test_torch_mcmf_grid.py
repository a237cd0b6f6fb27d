"""The mcmf kernel's cooperative grid, on the CPU: the sizing rule
`mcmf_grid`, the scratch count and the fits gate against the kernel
source's own constants, and the layouts of the seeded graphs that the
card-only tests (tests/test_torch_cuda.py) and chip_smoke.py use to
drive the cross-block paths."""

import re
from pathlib import Path

import numpy as np
import pytest

from ksched_tpu_torch.ops import mcmf

H100_SMS = 132
SOURCE = Path(mcmf.__file__).resolve().parent / "csrc" / "mcmf.cu"


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("entries", [1, 8, 512, 1000, 1024, 1025, 15_872, 131_072,
                                     135_168, 135_169, 153_600, 499_200])
def test_mcmf_grid_covers_every_entry(entries, per_sm):
    blocks, chunk = mcmf.mcmf_grid(entries, H100_SMS, per_sm)
    per_block = mcmf.MCMF_WARPS * chunk
    assert chunk % 32 == 0 and chunk >= 32
    assert 1 <= blocks <= H100_SMS * per_sm
    assert blocks * per_block >= entries  # every entry has a warp
    assert (blocks - 1) * per_block < entries  # no block without entries
    # one 32-entry step per warp while the co-resident blocks allow it
    if entries <= H100_SMS * per_sm * mcmf.MCMF_WARPS * 32:
        assert chunk == 32


@pytest.mark.parametrize("rows,blocks,chunk", [(1, 1, 32), (8, 4, 32), (31, 16, 32),
                                               (256, 128, 32), (300, 75, 64)])
def test_mcmf_grid_at_the_main_shapes(rows, blocks, chunk):
    """One block at R = 1, 128 at the 10k x 1k shape (R = 256) with 132
    SMs; past 132 x 1,024 entries two steps per warp on fewer blocks."""
    assert mcmf.mcmf_grid(rows * mcmf.MEGA_LANES, H100_SMS, 1) == (blocks, chunk)


def test_mcmf_grid_refuses_no_capacity():
    with pytest.raises(ValueError):
        mcmf.mcmf_grid(512, H100_SMS, 0)


def _constant(name):
    m = re.search(rf"\b{name} = (\d+)", SOURCE.read_text())
    assert m, f"{name} not in {SOURCE.name}"
    return int(m.group(1))


def test_scratch_count_matches_the_kernel_source():
    """The wrapper's scratch count and live-table count are the kernel's
    (kScratchTables tables, kHeadWords header words: the barrier, flag
    and end words, then two buffers of the soltel ring's kTelCounters
    counters; two words a block)."""
    src = SOURCE.read_text()
    assert _constant("kScratchTables") == mcmf.MCMF_SCRATCH_TABLES
    assert "kHeadWords = kTelWord + 2 * kTelCounters;" in src
    assert _constant("kTelWord") == 3 and _constant("kTelCounters") == 6
    assert _constant("kTelWord") + 2 * _constant("kTelCounters") == mcmf.MCMF_HEAD_WORDS
    assert f"{mcmf.MCMF_BLOCK_WORDS}LL * blocks" in src
    assert mcmf.MEGA_LIVE_TABLES == 9 + 1 + mcmf.MCMF_SCRATCH_TABLES
    assert mcmf.mcmf_scratch_words(131_072, 128) == 11 * 131_072 + 15 + 256


@pytest.mark.parametrize("rows", [1, 31, 256, 300, 975, 976])
def test_mega_fits_agrees_with_the_scratch_count(rows):
    """The gate counts the 10 input and output tables and the scratch at
    the most blocks a grid over those entries can have."""
    E = rows * mcmf.MEGA_LANES
    most_blocks = -(-E // (mcmf.MCMF_WARPS * 32))
    words = 10 * E + mcmf.mcmf_scratch_words(E, most_blocks)
    assert mcmf.mega_fits(E) == (4 * words <= mcmf.MEGA_BUDGET_BYTES)
    assert mcmf.mega_fits(E) == (rows <= 975)
    for sms, per_sm in ((H100_SMS, 1), (H100_SMS, 2), (1, 1)):
        assert mcmf.mcmf_grid(E, sms, per_sm)[0] <= most_blocks


def _layout(seed, tasks, machines, slots, arc_slots=None):
    """A seeded graph's entry layout under the H100 grid: (R, blocks,
    chunk, head flags)."""
    from ksched_tpu_torch.drivers import random_flow_problem
    from ksched_tpu_torch.solver.csr_solver import build_csr_plan
    from ksched_tpu_torch.solver.mega_solver import build_mega_plan

    p = random_flow_problem(np.random.default_rng(seed), tasks, machines, slots,
                            arc_slots=arc_slots)
    plan = build_mega_plan(build_csr_plan(p.src, p.dst, p.num_nodes))
    E = plan.R * plan.L
    blocks, chunk = mcmf.mcmf_grid(E, H100_SMS, 1)
    head = plan.e_hs != 0
    head[0] = True
    return plan.R, blocks, chunk, head


def test_cross_block_cases_have_the_layouts_they_test():
    """Seed 0 at 3,000 tasks: a segment over three blocks or more whose
    middle blocks hold no head, a head on a block's first entry, and an
    entry count that is not a multiple of a block's; seed 8 at 2,500
    tasks fills its blocks exactly; 15,000 tasks in 76,800 arc slots
    (R = 300) take two 32-entry steps per warp."""
    R, blocks, chunk, head = _layout(0, 3000, 100, 4)
    per_block = mcmf.MCMF_WARPS * chunk
    assert (R, blocks, chunk) == (31, 16, 32) and head.size % per_block != 0
    starts = np.flatnonzero(head)
    ends = np.r_[starts[1:], head.size] - 1
    spans = ends // per_block - starts // per_block + 1
    assert spans.max() >= 3
    s = int(np.argmax(spans))
    middle = range(starts[s] // per_block + 1, ends[s] // per_block)
    assert not any(head[b * per_block:(b + 1) * per_block].any() for b in middle)
    assert any(head[b * per_block] for b in range(1, blocks))

    R, blocks, chunk, head = _layout(8, 2500, 60, 3)
    assert (R, blocks, chunk) == (24, 12, 32) and head.size == blocks * 32 * chunk

    R, blocks, chunk, _head = _layout(5, 15_000, 1000, 8, arc_slots=76_800)
    assert (R, blocks, chunk) == (300, 75, 64)
