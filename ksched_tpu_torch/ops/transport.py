"""The dense layered-transport solves as CUDA kernels on Hopper.

Two kernels, each the WHOLE solve in one launch — price tightening, the
eps-scaling phase loop with saturate or price-refine waves between
phases, and every synchronous push/relabel superstep:

- `transport_loop` (csrc/transport.cu) replaces
  ksched_tpu/ops/transport_pallas.py::_transport_kernel (the
  `pl.pallas_call` in transport_loop_pallas): the solve with one arc
  per cell, warm-startable from carried machine prices;
- `transport_loop_tiered` (csrc/transport_tiered.cu) replaces
  `_transport_kernel_tiered` (the call in transport_loop_pallas_tiered):
  the preemption-on solve, two parallel arcs per cell (the residents'
  units at wLo, the rest at wHi), cold started.

Each reproduces its plain PyTorch version (solver/layered.py
`_solve_transport`, `_solve_transport_tiered`) bit for bit: y, pm,
steps and converged.

What bounds them on this card: neither bytes nor arithmetic. One solve
reads its cost tiles, supply and capacities once and writes y and pm
once (tens of KB at the [4, 1024] shape of a 1k-machine round), and
each superstep does a few tens of int32 operations per cell. The work
is a chain of dependent supersteps, each a few block-wide barriers
apart, so a solve is bound by the latency of one superstep on one SM
times the superstep count. Why one block: spreading a superstep over
SMs would cost a grid barrier (1.2-1.6 us on this card, PERF.md) for
each of its block barriers, more than a whole superstep takes here.
The design answers the latency instead: a single block of 1024 threads
holds the flow, the cost tiles, the per-superstep forward pushes and
every price and excess vector in shared memory when they fit in the
227 KB (they do at [4, 1024]; larger instances keep the tiles in
global memory, which at these sizes stays L2-resident), and every pass
keeps all 32 warps at work. Column passes take a thread per column.
Row passes (the forward push with its ordered prefix, the sink
push-back, the excess row sums, the refine waves' row bounds, the
prologue's tightening) follow `row_plan`: with fewer than 32 rows
(C + 1, the sink last) each warp takes one contiguous slice of one row
and a row's prefix is carried across its slices through one word per
slice, so a superstep is still three barriers; each lane moves four
columns as one 16-byte access, conflict-free, which `layout` makes
possible by padding every row to a whole number of 4-column groups
and starting every array on 16 bytes. The host reads back only steps
and converged after the launch — or nothing, when the caller keeps them
on the device. `cycles` is an optional probe: the launch's clock
cycles in each phase (PROBE_SLOTS).

The start eps may be a Python int or an int32 scalar tensor on the
card: a tensor is read by the kernel itself, so a device round can
launch a solve whose eps it computed without a host read.

The C interfaces are bound with ctypes; each library is built with nvcc
for sm_90a from its csrc/ source at first use (ops/build.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache, wraps

import numpy as np
import torch

from ..obs.spans import span
from .build import check_tensor as _check, kernel_attrs as _kernel_attrs, load, raise_on

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "transport": {
        "ksched_transport_solve": ([_VP] * 11 + [_CI] * 7 + [_VP] * 2, _CI),
        "ksched_transport_smem_budget": ([], ctypes.c_longlong),
        "ksched_transport_kernel_attrs": ([_CI, _VP], _CI),
    },
    "transport_tiered": {
        "ksched_transport_tiered_solve": ([_VP] * 12 + [_CI] * 6 + [_VP] * 2, _CI),
        "ksched_transport_tiered_smem_budget": ([], ctypes.c_longlong),
        "ksched_transport_tiered_kernel_attrs": ([_CI, _VP], _CI),
    },
}

#: warps of the kernels' one block (csrc/transport_common.cuh kWarps)
WARPS = 32
#: columns a lane moves as one 16-byte access (kGroup)
GROUP = 4
#: what each slot of a solve's `cycles` probe holds (kProbeExcess ..
#: kProbeTotal): phase A (the excess test and the admissible sweep),
#: phase B (the rows' push prefix), the column phase with the row
#: relabels, the phase starts (saturate, refine waves), and the whole
#: launch
PROBE_SLOTS = ("excess", "row", "column", "phase_start", "total")
#: each kernel's instantiations, in its `ksched_<kind>_kernel_attrs` order:
#: the state in shared memory or global, with the cycle probe or not
VARIANTS = ("shared+probe", "shared", "global+probe", "global")


def padded(n: int) -> int:
    """n rounded up to a whole number of 4-column groups."""
    return -(-n // GROUP) * GROUP


@dataclass(frozen=True)
class RowPlan:
    """Which warp sweeps which columns of which row in the kernels' row
    passes (csrc/transport_common.cuh `RowPlan`). Split: slice w is warp
    w's, groups [g0[w], g1[w]) of row row[w]; a row r's slices are warps
    first[r] .. first[r] + count[r] - 1. Not split: warp w takes whole
    rows w, w + 32, ... and the tuples are zeros."""

    split: bool
    row: tuple
    g0: tuple
    g1: tuple
    first: tuple
    count: tuple

    def pack(self) -> np.ndarray:
        """The words the kernels read: split, then the five tables."""
        return np.array([int(self.split), *self.row, *self.g0, *self.g1,
                         *self.first, *self.count], np.int32)

    def slices(self, C: int, Mp: int) -> list:
        """(warp, row, first column, end column) of every slice, as the
        kernels sweep them: row C is the sink; the end is cut at Mp."""
        if not self.split:
            return [(r % WARPS, r, 0, Mp) for r in range(C + 1)]
        return [(w, self.row[w], GROUP * self.g0[w], min(GROUP * self.g1[w], Mp))
                for w in range(WARPS)]


def row_plan(C: int, Mp: int) -> RowPlan:
    """The row-split plan for a [C, Mp] solve: rows 0..C (C the sink).
    With C + 1 < 32 rows every warp takes a contiguous, ascending slice
    of one row, a whole number of 4-column groups: the rows share the 32
    warps as evenly as can be (the earlier rows take the spare ones, the
    sink last), and a row's groups split as evenly over its warps (a
    slice may be empty). Otherwise one warp per row, striding."""
    rows = C + 1
    zeros = (0,) * WARPS
    if rows >= WARPS:
        return RowPlan(False, zeros, zeros, zeros, zeros, zeros)
    groups = padded(Mp) // GROUP
    row, g0, g1, first, count = [], [], [], [0] * WARPS, [0] * WARPS
    for r in range(rows):
        n = WARPS // rows + (r < WARPS % rows)
        first[r], count[r] = len(row), n
        for j in range(n):
            row.append(r)
            g0.append(groups * j // n)
            g1.append(groups * (j + 1) // n)
    return RowPlan(True, tuple(row), tuple(g0), tuple(g1), tuple(first), tuple(count))


#: the kernels' state arrays, in the order of csrc/transport_common.cuh
#: `CoreArray` and then each kernel's tiles (`TransportArray`,
#: `TieredArray`): [ld] vectors, [C] vectors, one word per slice, and
#: [C, ld] tiles, where ld = padded(Mp)
VECTORS = ("cap", "pm", "z", "ecol", "dzb")
ROW_VECTORS = ("supply", "pr0", "pr1", "erow")
SLICE_VECTORS = ("sl_flow", "sl_adm", "sl_ext", "sl_pushed")
TILES = {"transport": ("y", "df", "w"), "transport_tiered": ("y", "df", "r", "wlo", "whi")}
ARRAYS = {kind: VECTORS + ROW_VECTORS + SLICE_VECTORS + tiles
          for kind, tiles in TILES.items()}


@dataclass(frozen=True)
class Layout:
    """Where a solve's state lives: per ARRAYS[kind] entry its length in
    int32 words and its word offset, >= 0 in shared memory, < 0 at word
    ~offset of the global scratch; the dynamic shared memory and the
    scratch words the launch needs."""

    sizes: tuple
    offsets: tuple
    smem_bytes: int
    scratch_words: int


def layout(kind: str, C: int, Mp: int, smem_budget: int) -> Layout:
    """The state layout of a [C, Mp] solve of kernel `kind` within
    `smem_budget` bytes of shared memory: every vector in shared memory
    if they all fit, then each tile in ARRAYS order while it fits; the
    rest in the global scratch. Every array is a whole number of
    4-column groups long, so every one starts on 16 bytes."""
    ld = padded(Mp)
    sizes = ([ld] * len(VECTORS) + [padded(C)] * len(ROW_VECTORS)
             + [padded(max(WARPS, C + 1))] * len(SLICE_VECTORS)
             + [C * ld] * len(TILES[kind]))
    n_vec = len(VECTORS) + len(ROW_VECTORS) + len(SLICE_VECTORS)
    smem = [False] * len(sizes)
    used = sum(sizes[:n_vec])
    if 4 * used <= smem_budget:
        smem[:n_vec] = [True] * n_vec
        for k in range(n_vec, len(sizes)):
            if 4 * (used + sizes[k]) <= smem_budget:
                smem[k] = True
                used += sizes[k]
    else:
        used = 0
    offsets, at_smem, at_scratch = [], 0, 0
    for size, in_smem in zip(sizes, smem):
        if in_smem:
            offsets.append(at_smem)
            at_smem += size
        else:
            offsets.append(~at_scratch)
            at_scratch += size
    if at_scratch >= 1 << 31:
        raise ValueError(f"a [{C}, {Mp}] solve needs {at_scratch} scratch words, "
                         "past int32 offsets")
    return Layout(tuple(sizes), tuple(offsets), 4 * at_smem, at_scratch)


@lru_cache(maxsize=256)
def _launch_words(kind: str, C: int, Mp: int, smem_budget: int):
    """The plan's and the layout's words (int32 arrays the C launcher
    copies), the shared-memory bytes and the scratch words."""
    lay = layout(kind, C, Mp, smem_budget)
    return (row_plan(C, Mp).pack(), np.array(lay.offsets, np.int32),
            lay.smem_bytes, lay.scratch_words)


_budgets = {}


def _smem_budget(lib, kind: str, dev) -> int:
    """Kernel `kind`'s dynamic shared memory on `dev`, asked once."""
    key = (kind, dev.index)
    if key not in _budgets:
        got = int(getattr(lib, f"ksched_{kind}_smem_budget")())
        if got < 0:
            raise_on(lib, -got, kind)
        _budgets[key] = got
    return _budgets[key]


def _load(name: str):
    return load(name, _SIGNATURES[name])


def kernel_attrs(kind: str) -> dict:
    """Registers, local (spill) bytes, static shared bytes, max threads
    and blocks per SM of each VARIANTS instantiation of kernel `kind`
    ("transport" or "transport_tiered") on the current device, read from
    its loaded library (ops/build.py `kernel_attrs`)."""
    return _kernel_attrs(_load(kind), f"ksched_{kind}_kernel_attrs", VARIANTS)


def _no_probe_on_cpu(cycles):
    if cycles is not None:
        raise ValueError("cycles probes the kernel: the plain version has none")


def _check_cycles(cycles, device):
    """The probe's output: None, or an int64 tensor of len(PROBE_SLOTS)
    on the kernel's device, which the launch fills with the clock64()
    cycles of each phase."""
    if cycles is None:
        return None
    if (not isinstance(cycles, torch.Tensor) or cycles.dtype != torch.int64  # kschedlint: disable=dtype64 -- the cycle probe holds clock64() counts
            or tuple(cycles.shape) != (len(PROBE_SLOTS),)
            or cycles.device != device or not cycles.is_contiguous()):
        raise ValueError(f"cycles must be a contiguous int64 tensor of shape "
                         f"({len(PROBE_SLOTS)},) on {device}")
    return cycles.data_ptr()


def _check_common(w, supply, col_cap, eps_init, alpha, max_supersteps,
                  refine_waves):
    """Validation shared by both wrappers; returns (C, Mp, eps) with eps
    the int32 scalar tensor to read or None for a Python int."""
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"costs must be a non-empty [C, Mp] matrix, got {tuple(w.shape)}")
    C, Mp = w.shape
    _check("supply", supply, (C,), w.device)
    _check("col_cap", col_cap, (Mp,), w.device)
    if alpha < 2:
        raise ValueError(f"alpha must be >= 2, got {alpha}")
    if not 0 <= max_supersteps < 1 << 31 or not 0 <= refine_waves < 1 << 31:
        raise ValueError("max_supersteps and refine_waves must fit int32")
    if isinstance(eps_init, torch.Tensor):
        _check("eps_init", eps_init, (), w.device)
        return C, Mp, eps_init
    if not -(1 << 31) <= int(eps_init) < 1 << 31:
        raise ValueError(f"eps_init {int(eps_init)} does not fit int32")
    return C, Mp, None


def _launch_span(name: str):
    """Run the decorated solve inside a `name` span whose args are its
    instance's rows C and padded columns Mp."""

    def wrap(fn):
        @wraps(fn)
        def spanned(w, *args, **kw):
            C, Mp = (tuple(w.shape) + (0, 0))[:2]
            with span(name, C=C, Mp=Mp):
                return fn(w, *args, **kw)

        return spanned

    return wrap


@_launch_span("b1")
def transport_loop(wS, supply, col_cap, eps_init, pm0=None, *,
                   alpha: int = 8, max_supersteps: int = 20_000,
                   refine_waves: int = 0, cycles=None):
    """One transport solve: (y int32[C, Mp], pm int32[Mp], steps int32
    scalar, converged bool scalar), on wS's device.

    A CUDA tensor launches the kernel (one launch, counted in
    `transport_loop.launches`) or raises; a CPU tensor runs the plain
    PyTorch version, solver/layered.py `_solve_transport`. `cycles`, on
    the card only, receives the launch's phase probe (PROBE_SLOTS)."""
    if wS.device.type == "cpu":
        from ..solver.layered import _solve_transport

        _no_probe_on_cpu(cycles)
        return _solve_transport(
            wS, supply, col_cap, eps_init, pm0, alpha=alpha,
            max_supersteps=max_supersteps, refine_waves=refine_waves,
        )
    if wS.device.type != "cuda":
        raise ValueError(f"transport_loop runs on cuda or cpu, not {wS.device}")
    dev = wS.device
    C, Mp, eps_t = _check_common(wS, supply, col_cap, eps_init, alpha,
                                 max_supersteps, refine_waves)
    _check("wS", wS, (C, Mp), dev)
    if pm0 is not None:
        _check("pm0", pm0, (Mp,), dev)
    probe = _check_cycles(cycles, dev)

    lib = _load("transport")
    y = torch.empty((C, Mp), dtype=torch.int32, device=dev)
    pm = torch.empty(Mp, dtype=torch.int32, device=dev)
    result = torch.empty(2, dtype=torch.int32, device=dev)  # steps, converged
    with torch.cuda.device(dev):
        plan, offsets, smem, words = _launch_words(
            "transport", C, Mp, _smem_budget(lib, "transport", dev))
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ksched_transport_solve(  # kschedlint: program=layered_solve
            wS.data_ptr(), supply.data_ptr(), col_cap.data_ptr(),
            pm0.data_ptr() if pm0 is not None else None,
            eps_t.data_ptr() if eps_t is not None else None,
            y.data_ptr(), pm.data_ptr(), result.data_ptr(), scratch.data_ptr(),
            plan.ctypes.data, offsets.ctypes.data, smem,
            C, Mp, 0 if eps_t is not None else int(eps_init), alpha,
            max_supersteps, refine_waves, probe, stream,
        )
    raise_on(lib, rc, "transport")
    transport_loop.launches += 1
    return y, pm, result[0], result[1] != 0


#: kernel launches since the count was last set to 0
transport_loop.launches = 0


@_launch_span("b2")
def transport_loop_tiered(wLo, wHi, R, supply, col_cap, eps_init, *,
                          alpha: int = 8, max_supersteps: int = 20_000,
                          refine_waves: int = 0, cycles=None):
    """One tiered transport solve (the preemption-on round's): per cell
    the first R units at wLo, the rest at wHi, R clamped to the cell
    capacity. Returns (y int32[C, Mp], pm int32[Mp], steps int32 scalar,
    converged bool scalar), on wLo's device.

    A CUDA tensor launches the tiered kernel (one launch, counted in
    `transport_loop_tiered.launches`) or raises; a CPU tensor runs the
    plain PyTorch version, solver/layered.py `_solve_transport_tiered`.
    `cycles`, on the card only, receives the launch's phase probe."""
    if wLo.device.type == "cpu":
        from ..solver.layered import _solve_transport_tiered

        _no_probe_on_cpu(cycles)
        return _solve_transport_tiered(
            wLo, wHi, R, supply, col_cap, eps_init, alpha=alpha,
            max_supersteps=max_supersteps, refine_waves=refine_waves,
        )
    if wLo.device.type != "cuda":
        raise ValueError(
            f"transport_loop_tiered runs on cuda or cpu, not {wLo.device}")
    dev = wLo.device
    C, Mp, eps_t = _check_common(wLo, supply, col_cap, eps_init, alpha,
                                 max_supersteps, refine_waves)
    for name, t in (("wLo", wLo), ("wHi", wHi), ("R", R)):
        _check(name, t, (C, Mp), dev)
    probe = _check_cycles(cycles, dev)
    if eps_t is None:
        eps_t = torch.full((), int(eps_init), dtype=torch.int32, device=dev)

    lib = _load("transport_tiered")
    y = torch.empty((C, Mp), dtype=torch.int32, device=dev)
    pm = torch.empty(Mp, dtype=torch.int32, device=dev)
    result = torch.empty(2, dtype=torch.int32, device=dev)  # steps, converged
    with torch.cuda.device(dev):
        plan, offsets, smem, words = _launch_words(
            "transport_tiered", C, Mp, _smem_budget(lib, "transport_tiered", dev))
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ksched_transport_tiered_solve(  # kschedlint: program=layered_solve
            wLo.data_ptr(), wHi.data_ptr(), R.data_ptr(), supply.data_ptr(),
            col_cap.data_ptr(), eps_t.data_ptr(), y.data_ptr(), pm.data_ptr(),
            result.data_ptr(), scratch.data_ptr(), plan.ctypes.data,
            offsets.ctypes.data, smem, C, Mp, alpha, max_supersteps,
            refine_waves, probe, stream,
        )
    raise_on(lib, rc, "tiered transport")
    transport_loop_tiered.launches += 1
    return y, pm, result[0], result[1] != 0


#: kernel launches since the count was last set to 0
transport_loop_tiered.launches = 0
