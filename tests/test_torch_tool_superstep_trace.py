"""ksched_tpu_torch/tools/superstep_trace.py against ksched_tpu's
tools/superstep_trace.py, tolerance 0: on seeded transport instances
(the tail_repro npz layout) the port's numpy replica yields the JAX
tracer's SOLTEL_COLS rows and final flows, its objective and supersteps
equal those of the port's plain transport solve (solver/layered.py
`_solve_transport`), its rows those of that solve's soltel ring, and
the command line (`--table`, `--out`) prints what the JAX tool
prints."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tools import superstep_trace as jtrace

from ksched_tpu_torch.tools import superstep_trace as ttrace

ROOT = Path(__file__).resolve().parents[1]


def instance(seed, C=4, M=24, Mp=32):
    """A tail_repro-shaped instance: w[C, M] (escape-shifted costs),
    supply[C], col_cap[Mp] with zero-cap padding and the escape column."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-120, 20, (C, M))
    supply = rng.integers(5, 40, C)
    col_cap = np.zeros(Mp, np.int64)
    col_cap[:M] = rng.integers(0, 6, M)
    col_cap[-1] = supply.sum()
    return w, supply, col_cap


def padded(w, Mp, n_scale):
    C, M = w.shape
    wP = np.zeros((C, Mp), np.int64)
    wP[:, :M] = w
    return wP, wP * n_scale


CASES = [(seed, alpha, refine) for seed in (0, 1, 2) for alpha, refine in ((8, 8), (2, 0))]


@pytest.mark.parametrize("seed,alpha,refine", CASES)
def test_rows_match_the_jax_tracer_and_the_plain_solve(seed, alpha, refine):
    from ksched_tpu_torch.obs import soltel
    from ksched_tpu_torch.solver.layered import _solve_transport, default_eps0

    n_scale = 64
    w, supply, col_cap = instance(seed)
    M = w.shape[1]
    wP, wS = padded(w, col_cap.shape[0], n_scale)
    sched = ttrace.eps_schedule(default_eps0(n_scale), alpha)
    quiet = lambda *a, **k: None  # noqa: E731
    y, z, rows, conv = ttrace.run(wS, supply, col_cap, sched, refine_waves=refine,
                                  verbose_every=0, log=quiet)
    jy, jz, jrows, jconv = jtrace.run(wS, supply, col_cap, sched, refine_waves=refine,
                                      verbose_every=0)
    assert conv and jconv
    assert rows == jrows and len(rows) > 0
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(z, jz)
    assert ttrace.rows_to_telemetry(rows, 40000) == jtrace.rows_to_telemetry(jrows, 40000)

    cap = 1 << 12
    t = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32))  # noqa: E731
    yp, _pm, steps, converged, ring = _solve_transport(
        t(wS), t(supply), t(col_cap), sched[0], alpha=alpha, max_supersteps=1 << 17,
        refine_waves=refine, telemetry_cap=cap)
    assert bool(converged) and int(steps) == len(rows)
    obj = int((y[:, :M] * wP[:, :M]).sum())
    assert obj == int((yp.numpy().astype(np.int64)[:, :M] * wP[:, :M]).sum())
    tel = soltel.decode(ring, int(steps), cap, "layered", 1 << 17)
    assert [list(map(int, r)) for r in tel.rows] == rows


def _npz(tmp_path, seed):
    w, supply, col_cap = instance(seed)
    path = tmp_path / "tails.npz"
    np.savez(path, n=1, Mp=col_cap.shape[0], w_0=w, supply_0=supply, colcap_0=col_cap)
    return path


def test_command_line_prints_what_the_jax_tool_prints(tmp_path):
    path = _npz(tmp_path, 3)
    argv = ["--inst", str(path), "--k", "0", "--n-scale", "64", "--every", "5", "--table",
            "--out", str(tmp_path / "jax.json")]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    want = subprocess.run([sys.executable, "tools/superstep_trace.py", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert want.returncode == 0, want.stderr
    got = []
    argv[-1] = str(tmp_path / "torch.json")
    assert ttrace.main(argv, log=lambda *a, **k: got.append(" ".join(map(str, a)))) == 0
    want_lines = want.stdout.splitlines()
    assert got[:-1] == want_lines[:-1]
    assert got[-1] == f"telemetry -> {tmp_path / 'torch.json'}"
    with open(tmp_path / "jax.json") as f, open(tmp_path / "torch.json") as g:
        assert json.load(f) == json.load(g)
