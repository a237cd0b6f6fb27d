"""The card's peaks and the least time a kernel's work could take.

One NVIDIA H100 SXM (NVIDIA's data sheet and the Hopper white paper, at
its 700 W limit): HBM3 at 3.35 TB/s, and int32 work outside the tensor
cores at 64 int32 lanes an SM x 132 SMs x 1.98 GHz boost = 16.7 TOP/s
(the basis of the data sheet's 67 TFLOP/s of float32).

Kernel B1 (`ksched_tpu_torch/ops/csrc/transport.cu`, the cost-scaling
push-relabel over a dense [C, Mp] transport) needs, per cell of its
instance, 38 int32 operations a superstep (excesses 2, reduced costs 4,
forward admissibility and push 9, backward admissibility and push 10,
flow update 2, relabel candidates and push tests 11) and 6 at the start
of each eps phase (reduced cost 2, two compares and two selects 4); it
reads its costs, supply, capacities and start prices once and writes
its flow, prices and result once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

B1_OPS_PER_CELL_STEP = 38
B1_OPS_PER_CELL_PHASE = 6


def eps_phases(eps: int, alpha: int) -> int:
    """The eps phases after the first that a solve from eps runs."""
    phases, e = 0, int(eps)
    while e > 1:
        e = max(1, e // alpha)
        phases += 1
    return phases


def b1_bound_s(C: int, Mp: int, steps: int, eps: int, alpha: int, warm: bool) -> float:
    """The least seconds one B1 launch's work could take on the card:
    the larger of its bytes over the memory rate and its int32
    operations over the int32 rate."""
    nbytes = 4 * (2 * C * Mp + C + 2 * Mp + (Mp if warm else 0) + 2)
    ops = C * Mp * (B1_OPS_PER_CELL_STEP * steps
                    + B1_OPS_PER_CELL_PHASE * eps_phases(eps, alpha))
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
