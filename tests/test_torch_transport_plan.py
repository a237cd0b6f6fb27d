"""The transport kernels' row-split plan and state layout, on the CPU:
`row_plan` covers every cell of rows 0..C once in ascending slices on
16-byte boundaries, `layout` keeps every array on 16 bytes and fits the
main [4, 1024] shape in shared memory, a numpy model of the kernels'
split row prefix gives the one-sweep prefix bit for bit (int32 with
wrap), and the Python constants match the kernel sources' (csrc/).
The kernels themselves run in tests/test_torch_cuda.py on the card."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ksched_tpu_torch.ops import transport
from ksched_tpu_torch.ops.transport import (
    ARRAYS,
    GROUP,
    PROBE_SLOTS,
    WARPS,
    layout,
    padded,
    row_plan,
)

CSRC = Path(transport.__file__).resolve().parent / "csrc"
#: the H100's opt-in shared memory per block, less room for the kernels'
#: static shared variables
H100_SMEM = 232_448 - 1024

# the plan's edges (the card tests' and chip_smoke.py's), then the shapes
# the other card tests and chip_smoke.py solve
EDGES = [(4, 1024), (6, 1021), (31, 777), (33, 64), (3, 4)]
SHAPES = EDGES + [(2, 128), (5, 256), (8, 256), (16, 1152), (64, 4096),
                  (300, 3072), (400, 12544), (1, 1), (30, 5)]


def _cells(plan, C, Mp):
    """How often the plan's slices cover each cell of rows 0..C."""
    seen = np.zeros((C + 1, Mp), np.int64)
    for _w, r, m0, m1 in plan.slices(C, Mp):
        seen[r, m0:m1] += 1
    return seen


@pytest.mark.parametrize("C,Mp", SHAPES)
def test_row_plan_covers_every_cell_once(C, Mp):
    plan = row_plan(C, Mp)
    assert (_cells(plan, C, Mp) == 1).all()
    assert plan.split == (C + 1 < WARPS)


@pytest.mark.parametrize("C,Mp", SHAPES)
def test_row_plan_slices_ascend_on_16_bytes(C, Mp):
    """A row's slices sit on consecutive warps in column order, each a
    contiguous run of whole 4-column groups; split, every warp has one."""
    plan = row_plan(C, Mp)
    slices = plan.slices(C, Mp)
    for r in range(C + 1):
        mine = [s for s in slices if s[1] == r]
        assert [m0 for _w, _r, m0, _m1 in mine] == sorted(m0 for _w, _r, m0, _m1 in mine)
        end = 0
        for w, _r, m0, m1 in mine:
            assert m0 == end and m0 % GROUP == 0 and m1 >= m0
            end = max(end, m1)
        assert end == Mp
        if plan.split:
            warps = [w for w, *_ in mine]
            assert warps == list(range(plan.first[r], plan.first[r] + plan.count[r]))
    if plan.split:
        assert [w for w, *_ in slices] == list(range(WARPS))
    else:  # one warp per row, striding
        assert [(w, r) for w, r, *_ in slices] == [(r % WARPS, r) for r in range(C + 1)]


def test_row_plan_at_the_main_shape():
    """[4, 1024]: all 32 warps on slices of 36 to 43 groups (two steps of
    32 groups at most), 7, 7, 6, 6 and 6 warps for rows 0-3 and the sink."""
    plan = row_plan(4, 1024)
    assert plan.split and plan.count[:5] == (7, 7, 6, 6, 6)
    sizes = [b - a for a, b in zip(plan.g0, plan.g1)]
    assert min(sizes) == 36 and max(sizes) == 43


def test_row_plan_edges():
    """(6, 1021): a last group of one column and slices of 51 and 52
    groups; (3, 4): one group per row, so 28 of 32 warps sweep nothing;
    (31, 777): one warp per row; (33, 64): warps 0 and 1 take two rows."""
    plan = row_plan(6, 1021)
    assert padded(1021) == 1024 and plan.count[:7] == (5, 5, 5, 5, 4, 4, 4)
    assert {b - a for a, b in zip(plan.g0, plan.g1)} == {51, 52, 64}
    plan = row_plan(3, 4)
    assert sum(b > a for a, b in zip(plan.g0, plan.g1)) == 4
    assert [s for s in plan.slices(3, 4) if s[3] > s[2]] == [
        (7, 0, 0, 4), (15, 1, 0, 4), (23, 2, 0, 4), (31, 3, 0, 4)]
    assert not row_plan(31, 777).split
    rows_of = {}
    for w, r, *_ in row_plan(33, 64).slices(33, 64):
        rows_of.setdefault(w, []).append(r)
    assert rows_of[0] == [0, 32] and rows_of[1] == [1, 33] and rows_of[2] == [2]


@pytest.mark.parametrize("kind", list(ARRAYS))
@pytest.mark.parametrize("C,Mp", SHAPES)
def test_layout_keeps_16_bytes_and_fits(kind, C, Mp):
    lay = layout(kind, C, Mp, H100_SMEM)
    assert len(lay.offsets) == len(lay.sizes) == len(ARRAYS[kind])
    assert all(n % GROUP == 0 for n in lay.sizes)
    assert all(o % GROUP == 0 if o >= 0 else ~o % GROUP == 0 for o in lay.offsets)
    assert lay.smem_bytes <= H100_SMEM
    assert lay.smem_bytes == 4 * sum(n for n, o in zip(lay.sizes, lay.offsets) if o >= 0)
    assert lay.scratch_words == sum(n for n, o in zip(lay.sizes, lay.offsets) if o < 0)
    # no two arrays overlap, in either memory
    for space in (1, -1):
        spans = sorted((o if space > 0 else ~o, n) for n, o in zip(lay.sizes, lay.offsets)
                       if (o >= 0) == (space > 0))
        assert all(a + n <= b for (a, n), (b, _m) in zip(spans, spans[1:]))
    ld = padded(Mp)
    words = dict(zip(ARRAYS[kind], lay.sizes))
    assert words["pm"] == ld and words["y"] == C * ld
    assert words["sl_flow"] >= max(WARPS, C + 1) and words["supply"] >= C


@pytest.mark.parametrize("kind", list(ARRAYS))
def test_layout_holds_the_main_shape_in_shared_memory(kind):
    """At [4, 1024] every array of both kernels is in shared memory (the
    tiered kernel's 103 KB, B1's 70 KB); at [400, 12544] none is."""
    lay = layout(kind, 4, 1024, H100_SMEM)
    assert all(o >= 0 for o in lay.offsets) and lay.scratch_words == 0
    assert lay.smem_bytes == {"transport": 70_208, "transport_tiered": 102_976}[kind]
    lay = layout(kind, 400, 12_544, H100_SMEM)
    assert all(o < 0 for o in lay.offsets) and lay.smem_bytes == 0
    lay = layout(kind, 4, 1024, 0)
    assert all(o < 0 for o in lay.offsets)


def _split_prefix(a, plan, C, Mp):
    """The kernels' push prefix of rows 0..C-1 of `a` (int32 [C, Mp]) as
    phases A and B compute it: each slice's total, the carry of the
    row's earlier slices, then per 32-group step of the slice a lane scan
    of four-column sums and the running sum within a lane; all int32
    with wrap. Returns the exclusive prefix of every cell."""
    ld = padded(Mp)
    a = np.concatenate([a, np.zeros((C, ld - Mp), np.int32)], axis=1)
    excl = np.zeros_like(a)
    slices = []
    for _w, r, m0, m1 in plan.slices(C, Mp):
        if r < C:
            g0, g1 = m0 // GROUP, -(-m1 // GROUP) if m1 > m0 else m0 // GROUP
            slices.append((r, g0, g1, a[r, GROUP * g0:GROUP * g1].sum(dtype=np.int32)))
    for i, (r, g0, g1, _t) in enumerate(slices):
        carry = np.int32(0)
        for r2, *_rest, t in slices[:i]:  # a row's slices come in column order
            if r2 == r:
                carry = carry + t
        for base in range(g0, g1, 32):
            groups = a[r, GROUP * base:GROUP * min(base + 32, g1)].reshape(-1, GROUP)
            local = groups.sum(axis=1, dtype=np.int32)
            lane_excl = np.cumsum(local, dtype=np.int32) - local
            within = np.cumsum(groups, axis=1, dtype=np.int32) - groups
            cells = carry + lane_excl[:, None] + within
            excl[r, GROUP * base:GROUP * base + cells.size] = cells.reshape(-1)
            carry = carry + local.sum(dtype=np.int32)
    return excl[:, :Mp]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("C,Mp", EDGES + [(2, 128), (16, 1152)])
def test_split_prefix_is_the_one_sweep_prefix(seed, C, Mp):
    """With values up to 2^30 the sums wrap; the split prefix and the
    pushes it gives still equal the plain version's one cumsum."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 30, (C, Mp)).astype(np.int32)
    a[rng.random((C, Mp)) < 0.3] = 0
    e = rng.integers(-(1 << 31), 1 << 31, C, dtype=np.int64).astype(np.int32)
    with np.errstate(over="ignore"):
        got = _split_prefix(a, row_plan(C, Mp), C, Mp)
    at = torch.as_tensor(a)
    want = torch.cumsum(at, 1, dtype=torch.int32) - at
    assert np.array_equal(got, want.numpy())
    assert Mp < 64 or (np.cumsum(a.astype(np.int64), 1) >= 1 << 31).any()  # it wrapped
    push = torch.minimum(torch.clamp(torch.as_tensor(e)[:, None] - torch.as_tensor(got),
                                     min=0), at)
    want_push = torch.minimum(torch.clamp(torch.as_tensor(e)[:, None] - want, min=0), at)
    assert torch.equal(push, want_push)


def _source(name):
    return (CSRC / name).read_text()


def _constant(src, name):
    m = re.search(rf"\b{name} = ([^;]+);", src)
    assert m, f"{name} not found"
    return m.group(1).strip()


def _enum(src, name):
    """The enumerators of `enum name { ... }`, in order."""
    m = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S)
    assert m, f"enum {name} not found"
    body = re.sub(r"//[^\n]*", "", m.group(1))
    return [t.split("=")[0].strip() for t in body.split(",") if t.strip()]


def _camel(name):
    return "k" + "".join(part.capitalize() for part in name.split("_"))


def test_constants_match_the_kernel_sources():
    common = _source("transport_common.cuh")
    assert _constant(common, "kThreads") == "1024" and WARPS == 1024 // 32
    assert _constant(common, "kWarps") == "kThreads / 32"
    assert _constant(common, "kGroup") == str(GROUP)
    assert _constant(common, "kPlanWords") == "1 + 5 * kWarps"
    assert len(row_plan(4, 1024).pack()) == 1 + 5 * WARPS
    assert [_constant(common, f"kProbe{k}") for k in
            ("Excess", "Row", "Column", "Phase", "Total")] == ["0", "1", "2", "3", "4"]
    assert len(PROBE_SLOTS) == 5 and PROBE_SLOTS[-1] == "total"
    core = _enum(common, "CoreArray")
    assert core[-1] == "kCoreArrays"
    n_core = len(core) - 1
    assert core[:-1] == [_camel(n) for n in ARRAYS["transport"][:n_core]]
    assert ARRAYS["transport"][:n_core] == ARRAYS["transport_tiered"][:n_core]
    assert _constant(common, "kMaxArrays") == "kCoreArrays + 3"
    for kind, enum, count in (("transport", "TransportArray", "kTransportArrays"),
                              ("transport_tiered", "TieredArray", "kTieredArrays")):
        names = _enum(_source(f"{kind}.cu"), enum)
        assert names[-1] == count
        assert names[:-1] == [_camel(n) for n in ARRAYS[kind][n_core:]]
        assert len(ARRAYS[kind]) <= n_core + 3


def test_wrappers_refuse_a_probe_on_the_cpu():
    """The probe counts the kernel's cycles; the plain version has none."""
    wS = torch.zeros((1, 4), dtype=torch.int32)
    supply = torch.ones(1, dtype=torch.int32)
    cap = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    cycles = torch.zeros(len(PROBE_SLOTS), dtype=torch.int64)
    with pytest.raises(ValueError):
        transport.transport_loop(wS, supply, cap, 1, cycles=cycles)
    with pytest.raises(ValueError):
        transport.transport_loop_tiered(wS, wS, wS, supply, cap, 1, cycles=cycles)
    assert transport.transport_loop(wS, supply, cap, 1)[3]
