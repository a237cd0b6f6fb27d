"""Latency diagnostics for the device-resident scheduling round.

Measures, at ksched_tpu's tools/profile_round.py geometry (10k tasks on
1k machines x 4 PUs x 4 slots) on the card (`--device cuda`, the
default) or on the CPU:

1. the launch floor: a chain of R = 64 trivial launches (an in-place add
   on a one-element tensor) closed by one `synchronize()`, per launch;
   it bounds how fine a chained measurement can resolve;
2. the host round trip of one `synchronize()`: one trivial launch and
   the synchronize that waits for it;
3. the sustained steady round: R = 64 chained `run_steady_rounds`
   churn rounds (bench.py's protocol: 1% churn, each round's state
   feeding the next), closed by one `synchronize()`, wall over R.

Every measured repetition is an obs span (obs/spans.py): the medians
printed are computed from the spans' durations, and the session is
written out as a Chrome/Perfetto trace (`--trace-out`), so the numbers
printed and the trace a human inspects are one measurement
(tools/obs_report.py renders it).

On the card a launch is asynchronous: the host queues it and goes on.
So each timed chain is closed by exactly one `synchronize()`, which
waits for the chain's device work, and nothing is read back from the
card until every timing is done (the stats are fetched and checked for
convergence after). A chain of launches times what the host and the
device do together; `synchronize()` alone times one round trip.

Usage: python -m ksched_tpu_torch.tools.profile_round [--device cpu]
           [--trace-out profile_round_trace.json]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..obs.spans import SpanTracer, span

R = 64
#: tools/profile_round.py's geometry: machines, PUs a machine, slots a
#: PU, jobs, tasks, task capacity
GEOMETRY = dict(M=1000, P=4, S=4, J=10, T=10_000, Tcap=16384)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _med(fn, name: str, reps: int = 7, **args) -> float:
    """Median wall-ms of `fn` over `reps` calls, each timed as (and
    reported from) one obs span named `name`."""
    ts = []
    for i in range(reps):
        with span(name, rep=i, **args) as sp:
            fn()
        ts.append(sp.dur_s * 1e3)
    return float(np.median(ts))


def profile(device="cuda", geometry=None, rounds: int = R, reps: int = 7, log=print):
    """Run the three measurements on `device`; returns their medians (ms),
    the sha256 of each timed chain's stats and the tracer holding every
    span. `geometry`, `rounds` and `reps` cut the size for a check on
    the CPU."""
    from ..drivers.device_bulk import stats_sha256
    from ..scheduler.device_bulk import DeviceBulkCluster
    from ..utils.device import resolve_device

    dev_t = resolve_device(device)
    g = dict(GEOMETRY, **(geometry or {}))
    M, P, S, J, T = g["M"], g["P"], g["S"], g["J"], g["T"]
    tracer = SpanTracer().install()
    try:
        rng = np.random.default_rng(0)
        with span("setup", machines=M, tasks=T):
            dev = DeviceBulkCluster(num_machines=M, pus_per_machine=P, slots_per_pu=S,
                                    num_jobs=J, task_capacity=g["Tcap"], device=dev_t)
            dev.add_tasks(T, rng.integers(0, J, T).astype(np.int32))
        with span("fill_round"):
            fill = dev.round()
            _sync(dev_t)

        # the launch floor and one synchronize's round trip
        x = torch.zeros(1, dtype=torch.int32, device=dev_t)

        def chain():
            for _ in range(rounds):
                x.add_(1)
            _sync(dev_t)

        def round_trip():
            x.add_(1)
            _sync(dev_t)

        with span("launch_chain_warmup", launches=rounds):
            chain()
        chain_ms = _med(chain, "launch_chain", reps, launches=rounds)
        trip_ms = _med(round_trip, "sync_round_trip", reps)

        # the real thing: data-dependent steady rounds (bench protocol)
        churn_n = max(1, T // 100)
        with span("steady_warmup", rounds=rounds):
            dev.run_steady_rounds(rounds, 0.01, churn_n, seed=1)
            _sync(dev_t)
        stats = []

        def one_chunk():
            stats.append(dev.run_steady_rounds(rounds, 0.01, churn_n, seed=2 + len(stats)))
            _sync(dev_t)

        chunk_ms = _med(one_chunk, "steady_chunk", reps, rounds=rounds)
    finally:
        tracer.uninstall()
    # clock stopped: fetch and verify
    assert bool(dev.fetch_stats(fill)["converged"]), "fill round did not converge"
    fetched = [dev.fetch_stats(s) for s in stats]
    converged = all(bool(f["converged"].all()) for f in fetched)
    assert converged, "a steady round did not converge"
    assert int(x.item()) == rounds * (reps + 1) + reps, "launch chain lost a launch"
    out = {
        "device": str(dev_t), "geometry": g, "rounds": rounds,
        "launch_chain_ms": chain_ms, "launch_us": chain_ms / rounds * 1e3,
        "sync_round_trip_ms": trip_ms,
        "steady_chunk_ms": chunk_ms, "steady_round_us": chunk_ms / rounds * 1e3,
        "converged": converged, "chunks_sha256": [stats_sha256(f) for f in fetched],
        "tracer": tracer,
    }
    log(f"geometry: T={T} Tcap={dev.Tcap} M={M} P={P} S={S} device={dev_t}, "
        f"{rounds}-round chains")
    log(f"launch floor       : {out['launch_us']:8.2f} us/launch "
        f"({chain_ms:.3f} ms/chain of {rounds}, incl one synchronize)")
    log(f"sync round trip    : {trip_ms * 1e3:8.2f} us (one launch + synchronize)")
    log(f"steady round chain : {out['steady_round_us']:8.2f} us/round "
        f"({chunk_ms:.3f} ms/chunk)")
    return out


def main(argv=None, log=print) -> int:
    ap = argparse.ArgumentParser(prog="python -m ksched_tpu_torch.tools.profile_round")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--trace-out", default="profile_round_trace.json", metavar="PATH",
                    help="Chrome/Perfetto trace-event JSON of the measured spans "
                    "('' to skip)")
    args = ap.parse_args(argv)
    out = profile(args.device, log=log)
    if args.trace_out:
        out["tracer"].dump(args.trace_out)
        log(f"trace ({out['tracer'].mark()} spans) -> {args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
