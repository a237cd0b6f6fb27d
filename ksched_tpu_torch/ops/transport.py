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
times the superstep count. The design answers that by keeping the state
on chip and the launch count at one: a single block of 1024 threads
holds the flow, the cost tiles, the per-superstep forward pushes and
every price and excess vector in shared memory when they fit in the
227 KB (they do at [4, 1024]; larger instances keep the tiles in global
memory, which at these sizes stays L2-resident), every superstep costs
three barriers, and the host reads back only steps and converged after
the launch — or nothing, when the caller keeps them on the device.

The start eps may be a Python int or an int32 scalar tensor on the
card: a tensor is read by the kernel itself, so a device round can
launch a solve whose eps it computed without a host read.

The C interfaces are bound with ctypes; each library is built with nvcc
for sm_90a from its csrc/ source at first use (ops/build.py).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_tensor as _check, load, raise_on

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "transport": {
        "ksched_transport_solve": ([_VP] * 9 + [_CI] * 6 + [_VP], _CI),
        "ksched_transport_scratch_words": ([_CI, _CI], ctypes.c_longlong),
    },
    "transport_tiered": {
        "ksched_transport_tiered_solve": ([_VP] * 10 + [_CI] * 5 + [_VP], _CI),
        "ksched_transport_tiered_scratch_words": ([_CI, _CI], ctypes.c_longlong),
    },
}


def _load(name: str):
    return load(name, _SIGNATURES[name])


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


def transport_loop(wS, supply, col_cap, eps_init, pm0=None, *,
                   alpha: int = 8, max_supersteps: int = 20_000,
                   refine_waves: int = 0):
    """One transport solve: (y int32[C, Mp], pm int32[Mp], steps int32
    scalar, converged bool scalar), on wS's device.

    A CUDA tensor launches the kernel (one launch, counted in
    `transport_loop.launches`) or raises; a CPU tensor runs the plain
    PyTorch version, solver/layered.py `_solve_transport`."""
    if wS.device.type == "cpu":
        from ..solver.layered import _solve_transport

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

    lib = _load("transport")
    y = torch.empty((C, Mp), dtype=torch.int32, device=dev)
    pm = torch.empty(Mp, dtype=torch.int32, device=dev)
    result = torch.empty(2, dtype=torch.int32, device=dev)  # steps, converged
    scratch = torch.empty(
        int(lib.ksched_transport_scratch_words(C, Mp)), dtype=torch.int32,
        device=dev,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ksched_transport_solve(
            wS.data_ptr(), supply.data_ptr(), col_cap.data_ptr(),
            pm0.data_ptr() if pm0 is not None else None,
            eps_t.data_ptr() if eps_t is not None else None,
            y.data_ptr(), pm.data_ptr(), result.data_ptr(), scratch.data_ptr(),
            C, Mp, 0 if eps_t is not None else int(eps_init), alpha,
            max_supersteps, refine_waves, stream,
        )
    raise_on(lib, rc, "transport")
    transport_loop.launches += 1
    return y, pm, result[0], result[1] != 0


#: kernel launches since the count was last set to 0
transport_loop.launches = 0


def transport_loop_tiered(wLo, wHi, R, supply, col_cap, eps_init, *,
                          alpha: int = 8, max_supersteps: int = 20_000,
                          refine_waves: int = 0):
    """One tiered transport solve (the preemption-on round's): per cell
    the first R units at wLo, the rest at wHi, R clamped to the cell
    capacity. Returns (y int32[C, Mp], pm int32[Mp], steps int32 scalar,
    converged bool scalar), on wLo's device.

    A CUDA tensor launches the tiered kernel (one launch, counted in
    `transport_loop_tiered.launches`) or raises; a CPU tensor runs the
    plain PyTorch version, solver/layered.py `_solve_transport_tiered`."""
    if wLo.device.type == "cpu":
        from ..solver.layered import _solve_transport_tiered

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
    if eps_t is None:
        eps_t = torch.full((), int(eps_init), dtype=torch.int32, device=dev)

    lib = _load("transport_tiered")
    y = torch.empty((C, Mp), dtype=torch.int32, device=dev)
    pm = torch.empty(Mp, dtype=torch.int32, device=dev)
    result = torch.empty(2, dtype=torch.int32, device=dev)  # steps, converged
    scratch = torch.empty(
        int(lib.ksched_transport_tiered_scratch_words(C, Mp)),
        dtype=torch.int32, device=dev,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ksched_transport_tiered_solve(
            wLo.data_ptr(), wHi.data_ptr(), R.data_ptr(), supply.data_ptr(),
            col_cap.data_ptr(), eps_t.data_ptr(), y.data_ptr(), pm.data_ptr(),
            result.data_ptr(), scratch.data_ptr(), C, Mp, alpha,
            max_supersteps, refine_waves, stream,
        )
    raise_on(lib, rc, "tiered transport")
    transport_loop_tiered.launches += 1
    return y, pm, result[0], result[1] != 0


#: kernel launches since the count was last set to 0
transport_loop_tiered.launches = 0
