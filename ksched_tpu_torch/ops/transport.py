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
for sm_90a from its csrc/ source at first use, into ops/_build/.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
#: kernel name -> its CUDA source; every source includes HEADER
SOURCES = {
    "transport": CSRC / "transport.cu",
    "transport_tiered": CSRC / "transport_tiered.cu",
}
HEADER = CSRC / "transport_common.cuh"
BUILD_DIR = _HERE / "_build"

_libs = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the transport kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where kernel `name`'s library lives, named by the hash of its
    source and the shared header, so an edited source is rebuilt."""
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + HEADER.read_bytes()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libksched_{name}_{digest}.so"


def build(names=None) -> dict:
    """Compile the kernels' sources (all of them by default) into shared
    libraries under _build/, one nvcc process per source, all started
    together. Returns {name: library path}. `build.seconds[name]` is a
    compile's wall time (0 when the library was already there) and
    `build.log[name]` the compiler's resource report (-Xptxas -v)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            build.seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", str(CSRC), "-o", str(tmp), str(SOURCES[name]),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        build.seconds[name] = time.perf_counter() - t0
        build.log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


build.seconds = {}
build.log = {}


def _load(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "transport":
            lib.ksched_transport_solve.argtypes = [vp] * 9 + [ci] * 6 + [vp]
            lib.ksched_transport_solve.restype = ci
            lib.ksched_transport_scratch_words.argtypes = [ci, ci]
            lib.ksched_transport_scratch_words.restype = ctypes.c_longlong
        else:
            lib.ksched_transport_tiered_solve.argtypes = [vp] * 10 + [ci] * 5 + [vp]
            lib.ksched_transport_tiered_solve.restype = ci
            lib.ksched_transport_tiered_scratch_words.argtypes = [ci, ci]
            lib.ksched_transport_tiered_scratch_words.restype = ctypes.c_longlong
        lib.ksched_cuda_error_string.argtypes = [ci]
        lib.ksched_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the costs on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ksched_cuda_error_string(rc).decode())


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
    _raise_on(lib, rc, "transport")
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
    _raise_on(lib, rc, "tiered transport")
    transport_loop_tiered.launches += 1
    return y, pm, result[0], result[1] != 0


#: kernel launches since the count was last set to 0
transport_loop_tiered.launches = 0
