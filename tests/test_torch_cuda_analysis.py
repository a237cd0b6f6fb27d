"""The static-analysis suite's card checks (ksched_tpu_torch/analysis/
engine.py CARD_CHECKS) on the H100: each kernel's registers, spill,
static shared bytes and max threads against the registry's pins, B3's
grid gate and measured live set against `mega_fits`' reckoning, the
in-place appliers' memory growth, the launching routes' op counts
independent of supersteps, and the plain programs reading on CUDA
tensors the same pins tier-1 reads on the CPU. Marked `cuda`; every test
skips where no CUDA device is present. Imports nothing of JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_cuda_analysis.py --noconftest -q
"""

import pytest
import torch

from ksched_tpu_torch.analysis import engine
from ksched_tpu_torch.analysis import program_registry as reg

pytestmark = pytest.mark.cuda

DEV = "cuda"


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    engine.clear_cache()


CARD_PAIRS = [(s.name, c) for s in reg.PROGRAMS.values()
              for c in engine.applicable_card_checks(s)]


@pytest.mark.parametrize("pair", CARD_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_card_check(pair):
    name, check = pair
    engine.CARD_CHECKS[check](reg.PROGRAMS[name], DEV)


#: the programs whose plain version runs on a CUDA tensor as it is
PLAIN = [n for n, s in reg.PROGRAMS.items() if s.ranks == 0]


@pytest.mark.parametrize("name", PLAIN)
def test_plain_program_reads_the_cpu_pins_on_the_card(name):
    spec = reg.PROGRAMS[name]
    engine.check_default_call(spec, DEV)
    engine.check_hash_pin(spec, DEV)


def test_live_set_within_the_reckoning():
    got = engine.check_live_set(reg.PROGRAMS["mega_solve"], DEV)
    assert got["reckoned_bytes"] < got["measured_bytes"] <= \
        got["reckoned_bytes"] + got["slack_bytes"]


def test_a_resource_pin_off_by_one_fails(monkeypatch):
    k = reg.KERNELS["mcmf"]
    first = k.resources[0]
    bad = ((first[0], first[1] + 1) + first[2:],) + k.resources[1:]
    monkeypatch.setitem(reg.KERNELS, "mcmf", reg.KernelSpec(
        k.name, k.source, k.replaces, k.program, bad))
    with pytest.raises(engine.ContractError, match="program 'mega_solve'"):
        engine.check_kernel_resources(reg.PROGRAMS["mega_solve"], DEV)


def test_an_out_of_place_apply_shows_in_memory(monkeypatch):
    from ksched_tpu_torch.graph import device_export

    orig = device_export.delta_apply

    def apply(excess, src, dst, cap, cost, arc_rec, node_rec):
        return orig(excess, src, dst, cap.clone(), cost, arc_rec, node_rec)

    monkeypatch.setattr(device_export, "delta_apply", apply)
    with pytest.raises(engine.ContractError, match="program 'delta_apply'"):
        engine.check_inplace_memory(reg.PROGRAMS["delta_apply"], DEV)
