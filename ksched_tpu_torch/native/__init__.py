"""Native (C++) runtime components.

The reference delegates its MCMF solve to an external C++ binary
(Flowlessly) reached over pipes (scheduling/flow/placement/solver.go:
92-109). Here the native solver is an in-process shared library built
from mcmf.cpp on first use and bound via ctypes — no subprocess, no text
protocol, and a dead solver raises a Python exception instead of
panicking the scheduler (the reference's crash mode, solver.go:98-108).
"""

from .build import load_library, library_path

__all__ = ["load_library", "library_path"]
