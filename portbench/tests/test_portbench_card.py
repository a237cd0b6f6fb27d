"""The cell on the card: one short run of the command, as the benchmark
runs it. Skipped without a CUDA card."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "quincy10k-multiblock.steady", "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
