"""Start D ranks of an SPMD program on one host, for the multi-device
rung's runs and checks.

`run_ranks("module:function", world, payload)` starts `world` processes
with the `spawn` context (never fork: a parent that has initialised CUDA
cannot be forked safely), each of which sets `torch.set_num_threads(1)`,
joins a gloo process group through a FileStore in a fresh temporary
directory (no TCP port, so concurrent launches never clash) with a
`timeout`, calls `function(rank, world, payload)` and sends back its
result. The parent returns the results in rank order, or raises with
every rank's traceback. Every rank gets a join deadline: a rank that
hangs is killed and the call fails, so a hang costs its deadline and no
more.

The backend is gloo: one card cannot hold two NCCL ranks, and gloo
reduces CUDA tensors too, so D ranks may share a card. A program with
one card per rank joins NCCL through `mesh.init_group` itself.
"""

from __future__ import annotations

import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback


def _worker(rank, world, store, target, payload, out, timeout_s):
    import torch

    torch.set_num_threads(1)
    try:
        from .mesh import init_group

        init_group("gloo", rank, world, f"file://{store}", timeout_s=timeout_s)
        mod_name, fn_name = target.split(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        res = fn(rank, world, payload)
        out.put((rank, "ok", res))
    except BaseException:  # reported to the parent, whatever it was
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target: str, world: int, payload=None, deadline_s: float = 240.0,
              timeout_s: float = 120.0):
    """[result of rank 0, ..., result of rank world-1]. `target` names a
    module the ranks import by name and a function in it; `timeout_s`
    bounds each collective, `deadline_s` the whole run."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ksched_ranks_")
    store = os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, store, target, payload, out, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    end = time.monotonic() + deadline_s
    try:
        while len(results) + len(errors) < world:
            left = end - time.monotonic()
            if left <= 0:
                break
            try:
                rank, status, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and out.empty():
                    break
                continue
            (results if status == "ok" else errors)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, end - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors or len(results) < world:
        missing = sorted(set(range(world)) - set(results) - set(errors))
        detail = "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in sorted(errors.items()))
        raise RuntimeError(
            f"{target} on {world} ranks: {len(errors)} failed, ranks "
            f"{missing} gave no result within {deadline_s} s\n{detail}")
    return [results[r] for r in range(world)]
