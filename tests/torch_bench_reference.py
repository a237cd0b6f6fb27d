"""The JAX package's values for chip_smoke.py's bench phase.

Runs bench.py's own functions on the CPU with the arguments the smoke's
bench phase gives `python -m ksched_tpu_torch.bench`'s and prints the
values the smoke holds the port's records to (chip_smoke.py REF_BENCH):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_bench_reference.py [name ...]

Tied superstep counts in `top_rounds` rank by a stable sort, as the
port ranks them (`StableArgsort`). Names (default: all): 10kx1k (bench.py's headline at its defaults, 512
rounds in chunks of 64), coco50k and coco50k-preempt (`bench.py
--config`: their own budgets, 128 rounds in chunks of 32), mcmf-mega
(`--config mcmf-mega --override solves=2`). Per record: its metric with
the platform cut off, and every `detail` field but the chunk walls and
the latency model (timings, and a fit of them).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: detail fields that are walls, or fits derived from walls
TIMED = ("chunks_wall_ms", "latency_model")
#: per name: bench.py's arguments (the smoke passes the same to the port)
RUNS = {
    "10kx1k": dict(config="10kx1k", rounds=512, chunk=64, override=[]),
    "coco50k": dict(config="coco50k", rounds=512, chunk=64, override=[]),
    "coco50k-preempt": dict(config="coco50k-preempt", rounds=512, chunk=64, override=[]),
    "mcmf-mega": dict(config="mcmf-mega", rounds=512, chunk=64, override=["solves=2"]),
}
#: mcmf-mega's per-backend detail fields that are not walls
MEGA_FIELDS = ("nodes", "arcs", "entries", "solves")


def untimed(rec: dict) -> dict:
    """A record's values that do not depend on the clock: its metric up to
    the platform, and its detail without walls and fits of walls (for
    mcmf-mega: the graph and each backend's supersteps)."""
    metric = rec["metric"].rsplit("/", 1)[0]
    d = rec["detail"]
    if rec.get("config") == "mcmf-mega":
        keep = {k: d[k] for k in MEGA_FIELDS}
        keep.update({b: d[b]["supersteps"] for b in ("mega", "csr", "ell") if b in d})
        return {"metric": metric, "detail": keep}
    return {"metric": metric, "detail": {k: v for k, v in d.items() if k not in TIMED}}


class StableArgsort:
    """numpy, but `argsort` defaults to the stable sort: bench.py's
    top_rounds takes the default sort, which orders tied superstep
    counts as the numpy build's SIMD sort does (differently on two
    machines); the port ranks ties by a stable sort, and so does its
    reference."""

    def __init__(self, np):
        self._np = np

    def __getattr__(self, name):
        return getattr(self._np, name)

    def argsort(self, a, axis=-1, kind=None, order=None):
        return self._np.argsort(a, axis=axis, kind=kind or "stable", order=order)


def jax_record(name: str) -> dict:
    """bench.py's `run_config` on the CPU (ties in top_rounds ranked by a
    stable sort), its printed record."""
    import bench

    args = argparse.Namespace(verbose=False, fell_back=False, **RUNS[name])
    buf = io.StringIO()
    np = bench.np
    bench.np = StableArgsort(np)
    try:
        with contextlib.redirect_stdout(buf):
            bench.run_config(args)
    finally:
        bench.np = np
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def main() -> int:
    names = sys.argv[1:] or list(RUNS)
    out = {"args": {n: RUNS[n] for n in names}}
    for name in names:
        rec = jax_record(name)
        if name == "mcmf-mega":
            # the mega kernel runs under the Pallas interpreter on the
            # CPU: its flows equal the CSR solve's bit for bit
            assert rec["detail"]["mega"]["supersteps"] == rec["detail"]["csr"]["supersteps"]
        out[name] = untimed(rec)
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
