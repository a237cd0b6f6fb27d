"""Building and loading the port's CUDA kernels.

Each kernel's source under csrc/ is compiled with nvcc for sm_90a into a
shared library with a plain C interface under ops/_build/ (git ignored)
at first use, and loaded with ctypes. A library is named by the hash of
its source and the shared headers, so an edited source is rebuilt.
`build()` starts one nvcc per source, all at once.
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
#: kernel name -> its CUDA source; every source may include HEADERS
SOURCES = {
    "transport": CSRC / "transport.cu",
    "transport_tiered": CSRC / "transport_tiered.cu",
    "mcmf": CSRC / "mcmf.cu",
}
HEADERS = (CSRC / "transport_common.cuh",)
BUILD_DIR = _HERE / "_build"

_libs = {}


class KernelError(RuntimeError):
    """A kernel did not build, load or launch. The solver degradation
    ladder (runtime/degrade.py) never absorbs it: a broken kernel fails
    the round instead of stepping down to a slower rung."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where kernel `name`'s library lives."""
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
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
        raise KernelError("\n".join(failed))
    return {name: library_path(name) for name in names}


build.seconds = {}
build.log = {}


def load(name: str, signatures: dict):
    """Kernel `name`'s library (built first if need be), with each C
    function's (argtypes, restype) from `signatures` set, and
    `ksched_cuda_error_string` bound."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.ksched_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ksched_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


#: what a `ksched_<kernel>_kernel_attrs` query fills, in order
ATTR_FIELDS = ("registers", "local_bytes", "shared_bytes", "max_threads",
               "blocks_per_sm")


def kernel_attrs(lib, query: str, variants) -> dict:
    """{variant: {ATTR_FIELDS: value}} of a library's kernel
    instantiations on the current device, from its `query(k, out)`
    export (cudaFuncGetAttributes and the occupancy calculator)."""
    out = {}
    buf = (ctypes.c_int * len(ATTR_FIELDS))()
    for k, variant in enumerate(variants):
        rc = getattr(lib, query)(k, buf)
        if rc != 0:
            raise KernelError(f"{query}({k}) failed: " + (
                "no such kernel" if rc < 0
                else lib.ksched_cuda_error_string(rc).decode()))
        out[variant] = dict(zip(ATTR_FIELDS, buf))
    return out


def check_tensor(name, t, shape, device) -> None:
    """Raise unless `t` is a contiguous int32 tensor on `device` of
    `shape` (a tuple; None matches any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and want != got for want, got in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel's inputs on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(lib, rc: int, what: str) -> None:
    """Raise if a launch's cudaGetLastError() code is not 0."""
    if rc != 0:
        raise KernelError(f"{what} kernel launch failed: "
                           + lib.ksched_cuda_error_string(rc).decode())
