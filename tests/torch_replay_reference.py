"""The JAX package's values for chip_smoke.py's replay and multiblock phases.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_replay_reference.py [config ...]

Runs, on the CPU, through the JAX package:

- ``gtrace12k``, ``gtrace12k-burst``, ``gtrace12k-coco``: the trace of
  ksched_tpu_torch/drivers/gtrace.py's config (the JAX package's own
  synthesize_trace with the same arguments), staged by the JAX
  package's DeviceTraceReplayDriver with the config's arguments, then
  its first staged windows replayed in chunks as gtrace.replay_chunks
  replays them (2 calls of 256 windows, seeds 1-2): per chunk
  (gtrace.chunk_summary) the sha256 of all its stats
  stacked as int32 in key order, whether every window converged, and a
  summary, and the `pu` sha256 after it; the staging metadata;
- ``gtrace12k-host``: the JAX package's TraceReplayDriver on its
  LayeredTransportSolver, 60 rounds of 5 s windows: per round placed,
  unscheduled and evicted counts (`record_rounds`), the totals, the
  final `task_pu` sha256;
- ``quincy10k-multiblock``: bench.py's scenario on the JAX package's
  DeviceBulkCluster and QuincyGroupTable (`jax_multiblock`, written from
  bench.py's `_quincy_multiblock_bench`): the fill's stats, 3
  chunks of 32 steady rounds (seeds 2-4), each after the table
  maintenance, their stats sha256, the table's counters, and bench.py's
  own `_multiblock_quality_probe` on the JAX package's
  LayeredTransportSolver, with the sha256 of its 16 solves' flows.

Each prints one JSON object: chip_smoke.py's REF_REPLAY, REF_HOST and
REF_MULTIBLOCK constants. On the CPU (each line ends with its
`cpu_seconds`): 76 s for gtrace12k, 116 s for gtrace12k-burst, 100 s
for gtrace12k-coco, 2-3 s for gtrace12k-host, 362-384 s for
quincy10k-multiblock.
"""

import hashlib
import json
import sys
import time

import numpy as np

from ksched_tpu.costmodels import device_costs
from ksched_tpu.drivers.trace_replay import (
    DeviceTraceReplayDriver,
    TraceReplayDriver,
    synthesize_trace,
)
from ksched_tpu.solver.layered import LayeredTransportSolver
from ksched_tpu_torch.drivers import gtrace, multiblock
from ksched_tpu_torch.drivers.device_bulk import stats_sha256


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def replay_reference(config: str) -> dict:
    machines, events = synthesize_trace(**gtrace.trace_args(config))
    kw, penalties = gtrace.driver_args(config)
    cost = None if penalties is None else device_costs.coco_device_cost_fn(penalties)
    driver = DeviceTraceReplayDriver(machines, class_cost_fn=cost, **kw)
    sch = driver.stage(events, window_s=gtrace.WINDOW_S)
    out = {k: int(sch[k]) for k in ("rounds", "submitted", "finished", "dropped")}
    out["widths"] = [int(sch[k].shape[1]) for k in ("adm_job", "done_rows", "tog_idx")]
    out["chunks"], out["chunk_pu_sha256"] = [], []
    for _c, stats in gtrace.replay_chunks(driver, sch):
        out["chunks"].append(gtrace.chunk_summary(driver.cluster.fetch_stats(stats)))
        out["chunk_pu_sha256"].append(
            sha256(np.asarray(driver.cluster.fetch_state()["pu"], np.int32)))
    return out


def record_rounds(driver, events, window_s: float, max_rounds=None):
    """The JAX package's TraceReplayDriver.replay, recording each round
    as the port's ReplayStats.round_log does: returns (the ReplayStats,
    per round (placed, unscheduled, evicted since the round before, the
    round's timing dict)). The JAX package's driver keeps only totals,
    so this wraps its cluster's round and set_machine_enabled."""
    cluster = driver.cluster
    round_fn, toggle_fn = cluster.round, cluster.set_machine_enabled
    rows, evicted = [], [0]

    def toggle(machine_index, enabled):
        out = toggle_fn(machine_index, enabled)
        evicted[0] += len(out)
        return out

    def one_round():
        res = round_fn()
        rows.append((len(res.placed_tasks), int(res.num_unscheduled), evicted[0],
                     dict(res.timing)))
        evicted[0] = 0
        return res

    cluster.round, cluster.set_machine_enabled = one_round, toggle
    try:
        stats = driver.replay(events, window_s=window_s, max_rounds=max_rounds)
    finally:
        del cluster.round, cluster.set_machine_enabled
    return stats, rows


def host_reference() -> dict:
    machines, events = synthesize_trace(**gtrace.HOST_TRACE)
    driver = TraceReplayDriver(machines, backend=LayeredTransportSolver(),
                               slots_per_machine=gtrace.HOST_SLOTS)
    stats, rows = record_rounds(driver, events, **gtrace.HOST_REPLAY)
    return {
        "placed": [r[0] for r in rows], "unscheduled": [r[1] for r in rows],
        "evicted": [r[2] for r in rows],
        "totals": {k: getattr(stats, k)
                   for k in ("rounds", "submitted", "finished", "placed", "evicted")},
        "task_pu_sha256": gtrace.placements_sha256(driver.cluster),
    }


class RecordingSolver:
    """A LayeredTransportSolver that keeps each solve's flow y, so the
    probe's placements, not only its rounded gaps, can be compared."""

    def __init__(self, solver):
        self.solver, self.ys = solver, []

    def solve_layered(self, problem):
        res = self.solver.solve_layered(problem)
        self.ys.append(res.y)
        return res


def jax_multiblock(**sizes):
    """bench.py's `_quincy_multiblock_bench` set-up (bench.py:1883-1963)
    on the JAX package, at `sizes` (multiblock.FULL's keys): returns a
    namespace with the rng, table, templates, popularity, cluster, the
    fill's groups and draw_groups / new_template / maintain_table."""
    from types import SimpleNamespace

    from ksched_tpu.costmodels.quincy_device import QuincyGroupTable
    from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster
    from ksched_tpu.utils import next_pow2

    z = dict(multiblock.FULL, **sizes)
    MBv = 1 << 20
    n_blocks, G, machines, n_templates = z["n_blocks"], z["num_groups"], z["machines"], z["n_templates"]
    rng = np.random.default_rng(7)
    table = QuincyGroupTable(num_groups=G, num_machines=machines,
                             cost_unit_mb=64, sig_unit_mb=128)
    block_sizes = (128 * MBv * np.exp(rng.exponential(1.2, n_blocks))).astype(np.int64)
    block_sizes = np.minimum(block_sizes, 4096 * MBv)
    for b in range(1, n_blocks + 1):
        table.blocks.register(b, int(block_sizes[b - 1]),
                              rng.choice(machines, size=3, replace=False).tolist())

    def new_template():
        k = int(rng.integers(2, 4))
        return sorted(rng.choice(n_blocks, size=k, replace=False) + 1)

    templates = [new_template() for _ in range(n_templates)]
    popularity = 1.0 / np.arange(1, n_templates + 1) ** 0.8
    popularity /= popularity.sum()

    def draw_groups(n):
        t_idx = rng.choice(n_templates, size=n, p=popularity)
        return table.groups_for(np.zeros(n, np.int32), [templates[t] for t in t_idx]), t_idx

    dev = DeviceBulkCluster(
        num_machines=machines, pus_per_machine=z["pus"], slots_per_pu=z["slots"],
        num_jobs=z["jobs"], task_capacity=next_pow2(z["tasks"] + 4096),
        num_groups=G, supersteps=1 << 17, decode_width=z["decode_width"],
        active_groups_cap=z["caps"], two_stage_eps0="quarter")
    init_groups, _ = draw_groups(z["tasks"])
    table.sync(dev)
    ns = SimpleNamespace(rng=rng, table=table, templates=templates, popularity=popularity,
                         cluster=dev, sizes=z, signatures_initial=len(table._sig2gid))

    def fill():
        dev.add_tasks(z["tasks"], rng.integers(0, z["jobs"], z["tasks"]).astype(np.int32),
                      groups=init_groups)
        return dev.round()

    def maintain_table():
        st = dev.fetch_state()
        live = np.asarray(st["live"])
        grp = np.asarray(st["grp"])
        table.evict_idle(np.bincount(grp[live], minlength=G), keep_fraction=0.75)
        for _ in range(32):
            templates[int(rng.integers(0, n_templates))] = new_template()
        _ = draw_groups(256)
        table.sync(dev)
        dev.set_arrival_groups(np.unique(sorted(table._sig2gid.values())))

    ns.fill, ns.maintain_table = fill, maintain_table
    return ns


def multiblock_reference(chunks=multiblock.CHUNKS, rounds=multiblock.CHUNK_ROUNDS,
                         probe_rounds=8, **sizes) -> dict:
    """The multiblock values at `sizes`: the fill's stats, per chunk its
    stats sha256 and summary, the table's counters, the probe's gaps."""
    import bench

    mb = jax_multiblock(**sizes)
    fill = mb.cluster.fetch_stats(mb.fill())
    out = {"fill": {k: int(np.asarray(v)) for k, v in fill.items()}, "chunks": []}
    for c in range(chunks):
        mb.maintain_table()
        got = mb.cluster.fetch_stats(mb.cluster.run_steady_rounds(
            rounds, multiblock.CHURN, mb.sizes["churn_n"], seed=multiblock.FIRST_SEED + c))
        ss = np.asarray(got["supersteps"])
        out["chunks"].append({
            "stats_sha256": stats_sha256(got),
            "converged": bool(np.asarray(got["converged"]).all()),
            "placed": int(np.asarray(got["placed"]).sum()),
            "supersteps_max": int(ss.max()),
            "active_groups_max": int(np.asarray(got["active_groups"]).max()),
        })
    out["counters"] = {"signatures_initial": mb.signatures_initial,
                       "signatures_final": len(mb.table._sig2gid),
                       "overflow_distinct": mb.table.overflowed,
                       "evicted": mb.table.evicted}
    out["pu_sha256"] = sha256(np.asarray(mb.cluster.fetch_state()["pu"], np.int32))
    solver = RecordingSolver(LayeredTransportSolver(max_supersteps=1 << 17))
    out["probe"] = bench._multiblock_quality_probe(
        mb.table, mb.templates, mb.popularity, mb.rng, solver, mb.sizes["machines"],
        n_rounds=probe_rounds)
    out["probe"]["y_sha256"] = multiblock.ys_sha256(solver.ys)
    return out


def reference(config: str) -> dict:
    if config in gtrace.GTRACE:
        return replay_reference(config)
    if config == "gtrace12k-host":
        return host_reference()
    if config == "quincy10k-multiblock":
        return multiblock_reference()
    raise SystemExit(f"unknown config {config!r}")


CONFIGS = tuple(gtrace.GTRACE) + ("gtrace12k-host", "quincy10k-multiblock")


def main(argv) -> int:
    for config in argv or CONFIGS:
        t0 = time.perf_counter()
        out = reference(config)
        out["cpu_seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({config: out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
