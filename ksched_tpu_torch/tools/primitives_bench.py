"""Calibrate the card's costs of the primitives that bound the general
scan-CSR and ELL solves: random gather, cumsum, the segmented max, and
dense row reductions, at the shapes the 10k x 1k flow graph produces.

The port of ksched_tpu's tools/tpu_primitives_bench.py (:33-186). These
are PyTorch's own operations timed as they are; no kernel is ported
here. Each measurement chains `reps` applications with a REAL
loop-carried dependency — the op's result feeds the next iteration's
operand through arithmetic (the JAX tool's docstring records why
`result * 0` is not one: XLA folds it and hoists the op out of the
loop; PyTorch's eager ops are not folded, and the dependency keeps it
so) — after one warm-up chain, closed by one synchronize. The JAX
tool's "flat gather + optimization_barrier" row measures an XLA fusion
decision and has no counterpart in eager PyTorch. The segmented max is
the CSR solve's (solver/csr_solver.py `_seg_reduce`: a cumsum of the
segment starts and a scatter_reduce "amax").

Usage: python -m ksched_tpu_torch.tools.primitives_bench [reps] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

_I32 = torch.int32


def timed_chain(body, state0, reps: int, label: str, results: dict, dev, log=None):
    """body(state) -> state of the same structure, chained `reps` times;
    results[label] = microseconds an application of the timed chain."""
    from ..bench import _sync

    def chain(s):
        for _ in range(reps):
            s = body(s)
        return s

    chain(state0)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    chain(state0)
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    per_us = wall_ms * 1e3 / reps
    results[label] = round(per_us, 2)
    if log is not None:
        log(f"  {label:34s} {per_us:9.2f} us/op  (wall {wall_ms:.0f} ms)")


def run(reps: int = 2048, device="cuda", N: int = 32768, E: int = 131072,
        ES: int = 32768, W: int = 8, log=None) -> dict:
    """Time each primitive on `device` at N nodes, E doubled residual
    entries (the CSR layout) and an ELL small block of [ES, W]; returns
    {"platform", "reps", "per_op_us"}."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    results = {}
    if log is not None:
        log(f"# platform={dev.type} reps={reps}")

    def ints(hi, shape):
        return torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32), device=dev)

    table = ints(100, N)
    idx_e = ints(N, E).long()  # kschedlint: index-only (gather index)
    idx_ell = ints(N, (ES, W)).long()  # kschedlint: index-only (gather index)
    vec_e = ints(100, E)
    mat = ints(100, (ES, W))
    flags = rng.random(E) < 0.25
    flags[0] = True  # the first entry opens a segment, as in a CSR plan
    flags = torch.as_tensor(flags, device=dev)
    idx_flat2 = ints(N, ES * W).long()  # kschedlint: index-only (gather index)
    seg = torch.cumsum(flags, 0, dtype=torch.int64) - 1  # kschedlint: index-only (scatter_reduce_'s segment ids)
    zeros = functools.partial(torch.zeros, dtype=_I32, device=dev)

    def g1(s):  # E random indices into an N-entry table (p[s_src] etc.)
        t, _ = s
        g = t[idx_e]
        return t + g[0], g

    timed_chain(g1, (table, zeros(E)), reps, f"gather {E} from {N} (flat int32)",
                results, dev, log)

    def g2(s):  # gather in ELL shape: [ES, W] indices
        t, _ = s
        g = t[idx_ell]
        return t + g[0, 0], g

    timed_chain(g2, (table, zeros((ES, W))), reps, f"gather [{ES},{W}] from {N}",
                results, dev, log)

    def g3(s):  # the same gather as flat gather + reshape
        t, _ = s
        g = t[idx_ell.reshape(-1)].reshape(ES, W)
        return t + g[0, 0], g

    timed_chain(g3, (table, zeros((ES, W))), reps, f"gather [{ES},{W}] via flat+reshape",
                results, dev, log)

    def g4(s):  # a flat gather at the same element count (2 * E)
        t, _ = s
        g = t[idx_flat2]
        return t + g[0], g

    timed_chain(g4, (table, zeros(ES * W)), reps, f"gather {ES * W} flat", results, dev,
                log)

    def cs(s):  # cumsum over E
        v, _ = s
        c = torch.cumsum(v, 0, dtype=_I32)
        return v + c[0], c

    timed_chain(cs, (vec_e, zeros(E)), reps, f"cumsum {E} (int32)", results, dev, log)

    def segmax(s):  # the CSR relabel's segmented max over E entries
        v, _ = s
        m = torch.full_like(v, -(1 << 30)).scatter_reduce_(0, seg, v, "amax",
                                                            include_self=False)
        return v + m[0], m

    timed_chain(segmax, (vec_e, zeros(E)), reps, f"segmented max {E}", results, dev, log)

    def rr(s):  # dense row reduce [ES, W] -> [ES] (the ELL per-node combine)
        m, _ = s
        r = torch.sum(m, dim=1, dtype=_I32)
        return m + r[0], r

    timed_chain(rr, (mat, zeros(ES)), reps, f"row-sum [{ES},{W}]", results, dev, log)

    def ew(s):  # one elementwise pass over E (the floor)
        v, _ = s
        v2 = v * 3 + 1
        return v2 - v2[0] // 2, v2

    timed_chain(ew, (vec_e, zeros(E)), reps, f"elementwise {E}", results, dev, log)
    return {"platform": dev.type, "reps": reps, "per_op_us": results}


def main(argv=None, log=print, err=functools.partial(print, file=sys.stderr)) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.primitives_bench")
    ap.add_argument("reps", nargs="?", type=int, default=2048)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    log(json.dumps(run(args.reps, args.device, log=err)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
