"""The port's quincy10k-multiblock scenario (ksched_tpu_torch
drivers/multiblock.py) on the CPU against bench.py's on the JAX package,
bit for bit, at a small size: 64 machines, G = 64 groups, the ladder
(16, 32), 120 templates over 40 blocks. The fill's stats, each chunk's
stats (after the table maintenance: LRU eviction, fresh templates,
re-sync, the arrival map), the cluster state and the table's counters,
then the compression-loss probe's gaps (bench.py's own
`_multiblock_quality_probe` on the JAX side)."""

import numpy as np
import pytest

from ksched_tpu_torch.drivers.device_bulk import stats_sha256
from ksched_tpu_torch.drivers.multiblock import Multiblock
from torch_replay_reference import jax_multiblock, multiblock_reference

SMALL = dict(tasks=120, machines=64, pus=2, slots=4, jobs=4, n_blocks=40, num_groups=64,
             n_templates=120, caps=(16, 32), decode_width=64, churn_n=30)
CHUNKS, ROUNDS = 3, 6


@pytest.fixture(scope="module")
def want():
    return multiblock_reference(chunks=CHUNKS, rounds=ROUNDS, probe_rounds=3, **SMALL)


@pytest.fixture(scope="module")
def port():
    mb = Multiblock(device="cpu", **SMALL)
    fill = mb.cluster.fetch_stats(mb.fill())
    chunks = [mb.cluster.fetch_stats(mb.chunk(ROUNDS, 2 + c)) for c in range(CHUNKS)]
    return mb, fill, chunks


def test_fill_matches(want, port):
    _mb, fill, _chunks = port
    assert {k: int(v) for k, v in fill.items()} == want["fill"]


@pytest.mark.parametrize("c", range(CHUNKS))
def test_chunk_matches(want, port, c):
    got = port[2][c]
    ref = want["chunks"][c]
    assert stats_sha256(got) == ref["stats_sha256"]
    assert bool(got["converged"].all()) == ref["converged"]
    assert int(got["active_groups"].max()) == ref["active_groups_max"]


def test_table_counters_and_state_match(want, port):
    """Signatures, overflow and LRU evictions (at least one) as in the
    JAX package's table; the final placements equal."""
    mb = port[0]
    assert mb.counters() == want["counters"]
    assert mb.counters()["evicted"] > 0
    import hashlib

    pu = mb.cluster.fetch_state()["pu"].astype(np.int32)
    assert hashlib.sha256(pu.tobytes()).hexdigest() == want["pu_sha256"]


def test_quality_probe_matches(want, port):
    """The probe continues the scenario's rng: its realized-cost gaps
    and every solve's flow equal bench.py's on the JAX package's table
    and solver."""
    got = port[0].quality_probe(n_rounds=3)
    for k in ("realized_cost_gap_mean", "realized_cost_gap_max", "y_sha256"):
        assert got[k] == want["probe"][k]
    assert len(got["realized_a"]) == len(got["realized_b"]) == 3


def test_twin_follows_bench_draw_order():
    """The JAX twin's set-up draws match the port's: same templates,
    popularity and fill groups, so both consume one default_rng(7)."""
    mb = Multiblock(device="cpu", **SMALL)
    twin = jax_multiblock(**SMALL)
    assert mb.templates == twin.templates
    np.testing.assert_array_equal(mb.popularity, twin.popularity)
    assert mb.signatures_initial == twin.signatures_initial
    assert mb.rng.integers(0, 1 << 30) == twin.rng.integers(0, 1 << 30)
