"""Compile-on-first-use build of the native MCMF library.

Equivalent in role to the reference's build/Dockerfile:5-12 step that
builds Flowlessly via cmake — except the artifact is a shared library
loaded in-process, rebuilt automatically when mcmf.cpp is newer than the
cached .so. Thread-safe via an atomic rename.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_SRC = os.path.join(os.path.dirname(__file__), "mcmf.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB = os.path.join(_BUILD_DIR, "libksched_mcmf.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path(force: bool = False) -> str:
    """Path to the compiled library, building it if missing, stale or
    ``force``d."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, _LIB)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native solver build failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


def load_library(force_build: bool = False) -> ctypes.CDLL:
    """Load (building if needed) and type the library. Cached per
    process; ``force_build`` rebuilds it from the source first."""
    global _lib
    with _lock:
        if _lib is not None and not force_build:
            return _lib
        lib = ctypes.CDLL(library_path(force=force_build))
        lib.ksched_mcmf_ctx_new.restype = ctypes.c_void_p
        lib.ksched_mcmf_ctx_new.argtypes = []
        lib.ksched_mcmf_ctx_free.restype = None
        lib.ksched_mcmf_ctx_free.argtypes = [ctypes.c_void_p]
        lib.ksched_mcmf_solve.restype = ctypes.c_int32
        lib.ksched_mcmf_solve.argtypes = [
            ctypes.c_void_p,  # ctx (nullable)
            ctypes.c_int32,  # algorithm
            ctypes.c_int32,  # n
            ctypes.c_int64,  # m
            ctypes.POINTER(ctypes.c_int32),  # src
            ctypes.POINTER(ctypes.c_int32),  # dst
            ctypes.POINTER(ctypes.c_int32),  # cap
            ctypes.POINTER(ctypes.c_int32),  # cost
            ctypes.POINTER(ctypes.c_int64),  # excess
            ctypes.POINTER(ctypes.c_int64),  # flow_out
            ctypes.POINTER(ctypes.c_int64),  # objective_out
            ctypes.POINTER(ctypes.c_int64),  # iters_out
        ]
        _lib = lib
        return _lib
