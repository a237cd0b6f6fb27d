"""ksched_tpu_torch/tools/shard_smoke.py on D = 2 gloo ranks against
ksched_tpu's tools/shard_smoke.py arms on 2 virtual devices, tolerance
0, at the Makefile's arguments (6 machines, 48 tasks, 24 rounds, 4
warm-up, seed 7): per arm every round's placements, the plan syncs
after warm-up, and for the chaos arm (FaultInjector around
ShardedJaxSolver on the sharded -> jax -> cpu_ref ladder) its
degradations, fault snapshot and landing rungs; both ranks alike (they
step down together); the command line on the CPU."""

import pytest
import torch

from torch_tools_reference import jax_shard

from ksched_tpu_torch.parallel.launch import run_ranks
from ksched_tpu_torch.tools import shard_smoke

ARMS = ("scan_csr", "sharded", "chaos")


@pytest.fixture(scope="module")
def ranks():
    args = dict(shard_smoke.MAKEFILE, verbose=False, device="cpu")
    return run_ranks("ksched_tpu_torch.tools.shard_smoke:rank_smoke", 2, args,
                     deadline_s=300, timeout_s=120)


@pytest.fixture(scope="module")
def jax_arms():
    return jax_shard(devices=2, **shard_smoke.MAKEFILE)


@pytest.mark.parametrize("arm", ARMS)
def test_arm_matches_the_jax_tool(ranks, jax_arms, arm):
    want = jax_arms[arm]
    for r, got in enumerate(ranks):
        assert got["backend"] == "gloo"
        assert got[arm] == want, f"rank {r}"
    assert len(want["placements_sha256"]) == shard_smoke.MAKEFILE["rounds"]


def test_chaos_lands_on_both_rungs_and_ranks_agree(ranks):
    chaos = ranks[0]["chaos"]
    assert chaos["degradations"] > 0 and chaos["faults"]
    assert chaos["rungs"]["sharded"] > 0 and chaos["rungs"]["jax"] > 0
    assert sum(chaos["rungs"].values()) == shard_smoke.MAKEFILE["rounds"]
    assert ranks[1]["chaos"] == chaos
    assert ranks[0]["log"][-1] == "shard-smoke OK"


def test_command_line(capsys):
    assert shard_smoke.main(["--rounds", "8", "--warmup", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "shard-smoke OK" in out
    assert out[-1].startswith("shard-smoke: 2 ranks (gloo) agree")


def test_command_line_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_smoke.main([])
