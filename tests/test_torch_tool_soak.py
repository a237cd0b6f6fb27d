"""drivers/soak.py's device soak against ksched_tpu's tools/soak.py on
the CPU, tolerance 0: at `--machines 40 --tasks 400 --rounds 32 --chunk
8`, plain, with `--preempt`, and each with `--checkpoint-every 2`, every
chunk's line (live tasks, placements and supersteps a round, the
slowest round, machines down, and with --preempt the full re-solves,
migrations and preemptions; the checkpoint round trips) equals what the
JAX tool prints with `--cpu`. A seeded corruption of pu_running trips
the recount check; the CLI's modes are tools/soak.py's."""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from tools import soak as jsoak

from ksched_tpu_torch.drivers import soak as tsoak

ARGS = ["--machines", "40", "--tasks", "400", "--rounds", "32", "--chunk", "8"]
MODES = {"plain": [], "checkpoint": ["--checkpoint-every", "2"],
         "preempt": ["--preempt"], "preempt-checkpoint": ["--preempt", "--checkpoint-every", "2"]}


def jax_lines(argv):
    """tools/soak.py --cpu's chunk lines, its SOAK OK line left out."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["soak.py", "--cpu", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            assert jsoak.main() == 0
    finally:
        sys.argv = old
    lines = buf.getvalue().splitlines()
    assert lines[-1].startswith("SOAK OK: ")
    return lines[:-1]


def soak_args(argv):
    return tsoak.parse_args(argv + ["--device", "cpu"])


@pytest.mark.parametrize("mode", list(MODES))
def test_device_soak_matches_the_jax_tool(mode):
    argv = ARGS + MODES[mode]
    logged = []
    res = tsoak.run_bulk_soak(soak_args(argv), lambda s, **k: logged.append(s))
    want = jax_lines(argv)
    got = tsoak.bulk_soak_summary(res)
    assert got == want
    assert logged[:-1] == want and logged[-1].startswith("SOAK OK: 32 rounds")
    assert [r["round"] for r in res["chunks"]] == [8, 16, 24, 32]
    assert res["checkpoints"] == (2 if "checkpoint" in mode else 0)
    assert [r["down"] for r in res["chunks"]] == [0, 1, 0, 1]
    if "preempt" in mode:
        assert sum(r["full"] for r in res["chunks"]) >= 1


def test_corrupted_pu_running_trips_the_recount():
    """A seeded off-by-one in one PU's running count after a clean chunk:
    the invariant check that passed on the clean state names the drift."""
    args = soak_args(ARGS)
    dev, _cost_fn, _rng = tsoak.build_bulk_soak(args)
    got = dev.fetch_stats(dev.run_steady_rounds(8, 0.01, args.tasks // 100, seed=101))
    tsoak.check_bulk_invariants(dev, got, 8)
    pu = int(np.random.default_rng(0).integers(0, dev.num_pus))
    bad = dev.state.pu_running.clone()
    bad[pu] += 1
    dev.state = dev.state._replace(pu_running=bad)
    with pytest.raises(AssertionError, match="pu_running drift at round 8: max.delta.=1"):
        tsoak.check_bulk_invariants(dev, got, 8)
    # a task on a disabled machine trips the last check
    dev.state = dev.state._replace(pu_running=bad - (torch.arange(
        dev.num_pus, dtype=torch.int32) == pu).to(torch.int32))
    placed = dev.fetch_state()["pu"]
    m = int(placed[placed >= 0][0]) // dev.P
    dev.state = dev.state._replace(machine_enabled=dev.state.machine_enabled.clone())
    dev.state.machine_enabled[m] = False
    with pytest.raises(AssertionError, match="task on disabled machine at 8"):
        tsoak.check_bulk_invariants(dev, got, 8)


def test_cli_runs_the_device_soak_by_default(capsys):
    assert tsoak.main(ARGS + ["--rounds", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:-1] == jax_lines(ARGS[:4] + ["--rounds", "16", "--chunk", "8"])
    assert out[-1].startswith("SOAK OK: 16 rounds")


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsoak.main(ARGS)
