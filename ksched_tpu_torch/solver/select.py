"""One place to pick an MCMF backend by name.

Mirrors the reference's solver selection flags (placement/solver.go:
30-34). Every backend that runs device work takes ``device``: the
default ``"cuda"`` runs its solves in their CUDA kernels and raises
when no CUDA device is present; ``"cpu"`` runs the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

from .base import FlowSolver


def make_backend(name: str, device="cuda") -> FlowSolver:
    """name: "auto" | "jax" | "ell" | "mega" | "layered" | "ref".

    - "auto": AutoSolver — the dense transport whenever the graph
      audits as collapsible, else the mcmf kernel (MegaSolver) when the
      graph fits it, else the scan-CSR solve (CsrSolver);
    - "jax": CsrSolver, the scan-CSR solve (the JAX package's
      JaxSolver under the same name);
    - "ell": EllSolver, the bucketed-ELL layout of the same solve;
    - "mega": MegaSolver on every solve, delegating a graph it refuses
      to a CsrSolver;
    - "layered": LayeredTransportSolver (solve_layered only);
    - "ref": the exact host oracle (device is checked, not used)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if name == "auto":
        from .csr_solver import CsrSolver
        from .graph_collapse import AutoSolver
        from .mega_solver import MegaSolver

        return AutoSolver(CsrSolver(device=dev), mega=MegaSolver(device=dev),
                          device=dev)
    if name == "jax":
        from .csr_solver import CsrSolver

        return CsrSolver(device=dev)
    if name == "ell":
        from .ell_solver import EllSolver

        return EllSolver(device=dev)
    if name == "mega":
        from .csr_solver import CsrSolver
        from .mega_solver import MegaSolver

        return MegaSolver(fallback=CsrSolver(device=dev), device=dev)
    if name == "layered":
        from .layered import LayeredTransportSolver

        return LayeredTransportSolver(device=dev)
    if name == "ref":
        from .cpu_ref import ReferenceSolver

        return ReferenceSolver()
    raise ValueError(
        f"unknown backend {name!r}; want auto | jax | ell | mega | layered | ref")
