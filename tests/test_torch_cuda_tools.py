"""The operator tools on the card: the device soak, tail capture and its
three replays, profile_round's chains and the shard smoke's arms, each
on cuda against the same run on the CPU, bit for bit (the lines the
tools print, the npz arrays, the stats). Marked `cuda`; every test skips
where no CUDA device is present. Imports nothing of JAX, so it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda_tools.py --noconftest -q
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_tools_cases import small_config  # noqa: E402

from ksched_tpu_torch.drivers import soak  # noqa: E402
from ksched_tpu_torch.tools import profile_round, tail_repro  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("extra", [[], ["--preempt", "--checkpoint-every", "2"]],
                         ids=["plain", "preempt-checkpoint"])
def test_device_soak_on_card_matches_cpu(card, extra):
    from ksched_tpu_torch.ops.transport import transport_loop, transport_loop_tiered

    argv = ["--machines", "40", "--tasks", "400", "--rounds", "32", "--chunk", "8", *extra]
    want = soak.bulk_soak_summary(soak.run_bulk_soak(
        soak.parse_args(argv + ["--device", "cpu"]), _quiet))
    transport_loop.launches = transport_loop_tiered.launches = 0
    got = soak.bulk_soak_summary(soak.run_bulk_soak(
        soak.parse_args(argv + ["--device", "cuda"]), _quiet))
    assert got == want
    if extra:
        assert transport_loop_tiered.launches >= 1


REPLAYS = {"whare": ("replay", dict(alpha="2,8", refine="0,8")),
           "coco-preempt": ("replay-tiered", dict(refine="8")),
           "quincy": ("replay-grouped",
                      dict(strategies="two:1:256,two:n4:1024,full:n4:2,full:n:2"))}


@pytest.mark.parametrize("name", list(REPLAYS))
def test_capture_and_replay_on_card_match_cpu(card, tmp_path, name):
    kind, kw = REPLAYS[name]
    fn = {"replay": tail_repro.replay, "replay-tiered": tail_repro.replay_tiered,
          "replay-grouped": tail_repro.replay_grouped}[kind]
    runs = {}
    for device in ("cpu", "cuda"):
        dev, tasks, groups = small_config("torch", name, device=device)
        insts, ss = tail_repro.capture_rounds(dev, tasks, 4, 1, groups=groups, log=_quiet)
        out = tail_repro.instances_npz(dev, insts, groups is not None)
        path = tmp_path / f"{device}.npz"
        np.savez_compressed(path, **out)
        lines = []
        fn(argparse.Namespace(inst=str(path), device=device, **kw),
           lambda s, **k: lines.append(s))
        runs[device] = (ss.tolist(), out, lines)
    (ss_c, out_c, lines_c), (ss_g, out_g, lines_g) = runs["cpu"], runs["cuda"]
    assert ss_g == ss_c and lines_g == lines_c
    assert sorted(out_g) == sorted(out_c)
    for key in out_c:
        np.testing.assert_array_equal(out_g[key], out_c[key], err_msg=key)


def test_profile_round_chains_on_card_match_cpu(card):
    small = dict(M=20, P=2, S=2, J=4, T=60, Tcap=128)
    want = profile_round.profile("cpu", geometry=small, rounds=8, reps=3, log=_quiet)
    got = profile_round.profile("cuda", geometry=small, rounds=8, reps=3, log=_quiet)
    assert got["converged"] and got["chunks_sha256"] == want["chunks_sha256"]


def test_shard_smoke_on_card_matches_cpu(card):
    from ksched_tpu_torch.parallel.launch import run_ranks

    args = dict(machines=6, tasks=48, rounds=8, warmup=2, seed=7, verbose=False)
    runs = {device: run_ranks("ksched_tpu_torch.tools.shard_smoke:rank_smoke", 2,
                              dict(args, device=device), deadline_s=300, timeout_s=120)
            for device in ("cpu", "cuda")}
    for arm in ("scan_csr", "sharded", "chaos"):
        assert [g[arm] for g in runs["cuda"]] == [g[arm] for g in runs["cpu"]]
