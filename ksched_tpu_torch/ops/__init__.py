"""Device kernels for the solver hot ops, and their call sites.

`transport_solve` is the layered-transport solve and
`transport_solve_tiered` its preemption-on (continuation-priced) twin:
the CUDA kernels (ops/transport.py, sources in ops/csrc/) for tensors on
the card, the plain PyTorch versions (solver/layered.py
`_solve_transport`, `_solve_transport_tiered`) for tensors on the CPU.
`mcmf_solve` is the general-graph MCMF solve (ops/mcmf.py): its CUDA
kernel on the card, `mcmf_loop_plain` on the CPU. There is no mode
switch: the device of the tensors decides, and a CUDA tensor never
falls back to a plain version. Importing this module builds nothing; a
kernel is compiled at its first launch (ops/build.py).
"""

from .mcmf import mcmf_loop as mcmf_solve
from .transport import transport_loop as transport_solve
from .transport import transport_loop_tiered as transport_solve_tiered

__all__ = ["mcmf_solve", "transport_solve", "transport_solve_tiered"]
