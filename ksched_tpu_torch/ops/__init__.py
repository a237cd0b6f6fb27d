"""Device kernels for the solver hot ops, and their call sites.

`transport_solve` is the layered-transport solve and
`transport_solve_tiered` its preemption-on (continuation-priced) twin:
the CUDA kernels (ops/transport.py, sources in ops/csrc/) for tensors on
the card, the plain PyTorch versions (solver/layered.py
`_solve_transport`, `_solve_transport_tiered`) for tensors on the CPU.
There is no mode switch: the device of the tensors decides, and a CUDA
tensor never falls back to a plain version. Importing this module
builds nothing; a kernel is compiled at its first launch.
"""

from .transport import transport_loop as transport_solve
from .transport import transport_loop_tiered as transport_solve_tiered

__all__ = ["transport_solve", "transport_solve_tiered"]
