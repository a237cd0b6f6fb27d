"""ksched_tpu_torch/bench.py's `_round_latency_model` against bench.py's
on seeded synthetic chunk walls and per-round supersteps, tolerance 0
(equal dicts): one regime, the two-regime mixture (and its fallbacks at
3 chunks and with every round full), the degenerate fits (all-equal
superstep totals, a negative intercept refit through the origin, a
single chunk) and a leave-one-out suspect; with the constants it reads."""

import numpy as np
import pytest
import torch

import bench as jbench

from ksched_tpu_torch import bench as tbench


def _ss(rng, chunks, R, hi):
    return [rng.integers(0, hi, R) for _ in range(chunks)]


def _walls(rng, R, ss, fixed, kappa, noise, full=None, kappa_full=None):
    out = []
    for i, s in enumerate(ss):
        s = np.asarray(s, np.float64)
        if full is None:
            w = R * fixed + kappa * s.sum()
        else:
            f = np.asarray(full[i], bool)
            w = R * fixed + kappa * s[~f].sum() + kappa_full * s[f].sum()
        out.append(round(float(w * (1 + noise * rng.standard_normal())), 1))
    return out


def _case(name, seed):
    """(walls, R, supersteps per chunk, full flags or None, the fits the
    case can reach, None for any)."""
    rng = np.random.default_rng(seed)
    if name == "one-regime":
        R = 32
        ss = _ss(rng, 5, R, 400)
        return _walls(rng, R, ss, 2.5, 0.004, 0.02), R, ss, None, ("lstsq",)
    if name in ("mixture", "mixture-3-chunks"):
        R, chunks = 32, 7 if name == "mixture" else 3
        ss = _ss(rng, chunks, R, 300)
        full = [rng.random(R) < 0.1 + 0.05 * i for i in range(chunks)]
        for f, s in zip(full, ss):
            s[f] += rng.integers(1000, 5000, int(f.sum()))
        walls = _walls(rng, R, ss, 3.0, 0.004, 0.01, full, 0.02)
        # 3 chunks never take the 2-regime fit (zero residual df)
        return walls, R, ss, full, (("lstsq-2regime",) if chunks >= 4
                                    else ("lstsq", "origin"))
    if name == "all-full":
        R = 16
        ss = _ss(rng, 4, R, 900)
        full = [np.ones(R, bool) for _ in range(4)]
        return _walls(rng, R, ss, 1.0, 0.01, 0.02), R, ss, full, ("lstsq",)
    if name == "chunk-mean":
        R = 64
        ss = [np.full(R, 7) for _ in range(4)]
        return [round(float(w), 1) for w in 150 + 20 * rng.random(4)], R, ss, None, ("chunk-mean",)
    if name == "origin":
        R = 8
        ss = _ss(rng, 4, R, 1000)
        tot = np.array([s.sum() for s in ss], np.float64)
        walls = [round(float(0.05 * t - 40.0 + rng.random()), 1) for t in tot]
        return walls, R, ss, None, ("origin",)
    if name == "single-chunk":
        R = 128
        ss = _ss(rng, 1, R, 50)
        return [321.5], R, ss, None, ("chunk-mean",)
    if name == "loo-suspect":
        R = 32
        ss = _ss(rng, 6, R, 400)
        walls = _walls(rng, R, ss, 2.0, 0.004, 0.01)
        walls[2] = round(walls[2] * 3.0, 1)
        return walls, R, ss, None, None
    if name == "per-round":
        # gtrace100k's use: each round its own R = 1 chunk
        lat = list(np.round(200 + 30 * rng.random(12), 1))
        ss = [[int(x)] for x in rng.integers(5, 60, 12)]
        return lat, 1, ss, None, None
    raise KeyError(name)


CASES = ["one-regime", "mixture", "mixture-3-chunks", "all-full", "chunk-mean", "origin",
         "single-chunk", "loo-suspect", "per-round"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", CASES)
def test_latency_model_equals_bench(name, seed):
    walls, R, ss, full, kind = _case(name, seed)
    want = jbench._round_latency_model(np.array(walls), R, ss, full_per_chunk=full)
    got = tbench._round_latency_model(np.array(walls), R, ss, full_per_chunk=full)
    assert got == want
    if kind is not None:
        assert got["fit"] in kind
    if name == "loo-suspect":
        assert got["fit_suspect"] is True
    if name == "mixture":
        assert "per_superstep_us_full" in got and got["loo_rel_err_max"] >= 0


def test_latency_model_takes_lists_of_lists():
    """The call shapes of bench.py's callers: walls as a list, ss as
    lists of ints (gtrace100k) or arrays (the chunked configs)."""
    walls = [10.0, 12.5, 11.0]
    ss = [[3, 4], [5, 9], [1, 2]]
    assert (tbench._round_latency_model(walls, 2, ss)
            == jbench._round_latency_model(walls, 2, ss))


def test_constants_equal_bench():
    assert tbench.LOO_SUSPECT_REL_ERR == jbench.LOO_SUSPECT_REL_ERR
    assert tbench.SUITE_CONFIGS == jbench.SUITE_CONFIGS
    assert tbench.EXTRA_CONFIGS == jbench.EXTRA_CONFIGS


class _RecordingCluster:
    """Stands in for a DeviceBulkCluster: records each steady chunk."""

    device = torch.device("cpu")

    def __init__(self):
        self.events = []

    def run_steady_rounds(self, R, churn, churn_n, seed):
        self.events.append(("chunk", R, churn, churn_n, seed))
        return {"seed": seed}


@pytest.mark.parametrize("chunks", [3, 4, 7])
def test_chunk_loop_makes_bench_calls_in_order(chunks):
    """bench.py's call order at a bar of 0 (each call advances the
    cluster): warm-up and probe with seed 1, then the measured chunks
    with seeds 2 + rep, the maintenance hook outside the clock ahead of
    each; no chunk is retried or grown."""
    cl = _RecordingCluster()
    walls, stats = tbench._chunk_loop(cl, 16, 0.01, 5, chunks,
                                      before_chunk=lambda: cl.events.append(("hook",)))
    want = [("chunk", 16, 0.01, 5, 1)] * 2
    for rep in range(chunks):
        want += [("hook",), ("chunk", 16, 0.01, 5, 2 + rep)]
    assert cl.events == want
    assert [s["seed"] for s in stats] == [2 + rep for rep in range(chunks)]
    assert len(walls) == chunks and all(w >= 0.0 for w in walls)
