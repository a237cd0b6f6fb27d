"""One identity for the card across the port.

`utils/device.py` `resolve_device` is where a device is named: an
index-less ``cuda`` becomes ``cuda:{current device}``, the device every
tensor made on ``"cuda"`` reports, so the entry points that compare a
stored device with a tensor's or with another entry point's (the mesh's
collectives, the sharded mirror, a tenancy lane and its batcher) compare
like with like. Here, with no card: `resolve_device` under a faked card,
a source scan that no other module builds a device it stores, the three
comparisons under a faked card, and a stray tensor in a collective
raising a TypeError that the degradation ladder does not absorb. The
same paths on the card, with no device argument anywhere:
tests/test_torch_cuda_default_device.py."""

import ast
import os
import shutil
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ksched_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ksched_tpu_torch"

#: the one module that may build a device from a caller's argument
DEVICE_MODULE = "utils/device.py"

#: `torch.device(x).type` only names the platform, and stores nothing:
#: allowed anywhere (bench.py's multitenant record label)
ALLOWED_ATTRS = ("type",)


@pytest.fixture
def fake_card(monkeypatch):
    """A card that is there, with `current` as the current device."""
    def set_current(current):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    return set_current


# ---------------------------------------------------------------------------
# resolve_device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("current", [0, 1])
@pytest.mark.parametrize("given", ["cuda", torch.device("cuda")], ids=["str", "device"])
def test_index_less_cuda_resolves_to_the_current_card(fake_card, current, given):
    fake_card(current)
    got = resolve_device(given)
    assert got == torch.device("cuda", current)
    assert got.index == current and str(got) == f"cuda:{current}"


@pytest.mark.parametrize("current", [0, 1])
@pytest.mark.parametrize("given", ["cuda:1", torch.device("cuda", 1)], ids=["str", "device"])
def test_an_index_is_kept(fake_card, current, given):
    fake_card(current)
    assert resolve_device(given) == torch.device("cuda", 1)


@pytest.mark.parametrize("given", ["cpu", torch.device("cpu")], ids=["str", "device"])
def test_cpu_is_what_cpu_tensors_report(fake_card, given):
    fake_card(0)
    got = resolve_device(given)
    assert got == torch.empty(1).device == torch.device("cpu")
    assert got.index is None


@pytest.mark.parametrize("given", ["cuda", "cuda:0", torch.device("cuda")])
def test_no_card_still_raises(monkeypatch, given):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_query():  # pragma: no cover - must not be reached
        raise AssertionError("current_device() asked with no card")

    monkeypatch.setattr(torch.cuda, "current_device", no_query)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(given)


# ---------------------------------------------------------------------------
# the source scan: no module but utils/device.py builds a device it keeps
# ---------------------------------------------------------------------------


def _port_modules():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    return files


def _device_builds(path):
    """(line, text) of every `torch.device(...)` call in `path` whose
    result is kept or passed on (anything but `torch.device(x).type`),
    and of every `torch.cuda.current_device()` call."""
    src = path.read_text()
    tree = ast.parse(src, filename=str(path))
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = ast.unparse(node.func)
        if name == "torch.cuda.current_device":
            found.append((node.lineno, ast.unparse(node)))
        elif name == "torch.device":
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and parent.attr in ALLOWED_ATTRS:
                continue
            found.append((node.lineno, ast.unparse(node)))
    return found


def test_only_resolve_device_builds_a_device():
    """Every module of the port scanned: the offenders, each named with
    its line and call, must be none."""
    offenders = []
    for path in _port_modules():
        rel = str(path.relative_to(PORT))
        found = _device_builds(path)
        if rel == DEVICE_MODULE:
            assert found, "resolve_device no longer builds the device"
            continue
        offenders += [(rel, line, text) for line, text in found]
    assert offenders == [], ("modules that build a device themselves (route it "
                             f"through utils.device.resolve_device): {offenders}")


def test_the_scan_sees_a_build_and_spares_a_type_read(tmp_path):
    """The scan's own rule, on a module written for it."""
    p = tmp_path / "m.py"
    p.write_text("import torch\n"
                 "def f(device):\n"
                 "    kind = torch.device(device).type\n"
                 "    dev = torch.device(device)\n"
                 "    pin = torch.device('cuda', torch.cuda.current_device())\n"
                 "    return kind, dev, pin\n")
    assert [line for line, _ in _device_builds(p)] == [4, 5, 5]


# ---------------------------------------------------------------------------
# the three comparisons, like with like
# ---------------------------------------------------------------------------


def test_a_lane_on_cuda0_is_taken_by_a_batcher_on_cuda(fake_card):
    from ksched_tpu_torch.tenancy.batch import LaneSolver, StackedBatcher

    fake_card(0)
    batcher = StackedBatcher(device="cuda")
    lane = LaneSolver(batcher, device="cuda:0")
    assert lane.device == batcher.device == torch.device("cuda", 0)
    default = LaneSolver(batcher)  # the entry point's own default
    assert default.device == batcher.device


def test_a_lane_on_another_device_is_a_type_error():
    from ksched_tpu_torch.tenancy.batch import LaneSolver, StackedBatcher

    with pytest.raises(TypeError, match="a lane on meta with a batcher on cpu"):
        LaneSolver(StackedBatcher(device="cpu"), device="meta")


def _mirror(device):
    from ksched_tpu_torch.graph.device_export import DeviceGraphState, DeviceResidentState

    return DeviceResidentState(DeviceGraphState(), device)


def test_a_mirror_on_cuda_takes_a_mesh_on_cuda0(fake_card):
    fake_card(0)
    res = _mirror("cuda")
    assert res.device == torch.device("cuda", 0)
    mesh = SimpleNamespace(device=resolve_device("cuda:0"), size=2)
    res.enable_sharded_plan(mesh)
    assert res._shard is mesh


def test_a_mesh_on_another_device_is_a_type_error():
    res = _mirror("cpu")
    with pytest.raises(TypeError, match="a mesh on meta for a mirror on cpu"):
        res.enable_sharded_plan(SimpleNamespace(device=torch.device("meta"), size=2))
    assert res._shard is None


# ---------------------------------------------------------------------------
# the mesh on a one-rank gloo group of this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group():
    import torch.distributed as dist

    from ksched_tpu_torch.parallel.mesh import init_group

    tmp = tempfile.mkdtemp(prefix="ksched_identity_")
    init_group("gloo", 0, 1, f"file://{os.path.join(tmp, 'store')}", timeout_s=30)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _problem():
    from ksched_tpu_torch.drivers.synthetic import random_flow_problem

    return random_flow_problem(np.random.default_rng(11), 9, 3, 2)


def test_a_mesh_made_on_cuda_holds_the_index(group, fake_card):
    from ksched_tpu_torch.parallel.mesh import ShardMesh

    fake_card(0)
    assert ShardMesh(None).device == torch.device("cuda", 0)
    assert ShardMesh(None, device="cuda").device == ShardMesh(None, device="cuda:0").device


@pytest.mark.parametrize("kind", ["psum", "pmax", "pmin", "all_gather"])
def test_a_stray_tensor_in_a_collective_is_a_type_error(group, kind):
    from ksched_tpu_torch.parallel.mesh import ShardMesh

    mesh = ShardMesh(None, device="cpu")
    x = torch.arange(4, dtype=torch.int32)
    assert torch.equal(getattr(mesh, kind)(x).reshape(-1), x)
    with pytest.raises(TypeError, match="collective on meta, mesh on cpu"):
        getattr(mesh, kind)(torch.empty(4, dtype=torch.int32, device="meta"))
    assert mesh.totals()[kind] == 1  # the refused collective was never issued


def test_the_one_rank_sharded_solve_equals_csr(group):
    """The control: at D = 1 the sharded solve orders the entries as the
    single-device CsrSolver does, so their results are equal."""
    from ksched_tpu_torch.parallel.mesh import ShardMesh
    from ksched_tpu_torch.parallel.sharded_solver import ShardedJaxSolver
    from ksched_tpu_torch.solver.csr_solver import CsrSolver

    sh = ShardedJaxSolver(ShardMesh(None, device="cpu"), telemetry=0)
    a = sh.solve(_problem())
    cs = CsrSolver(device="cpu", slot_stable=False, telemetry=0)
    b = cs.solve(_problem())
    np.testing.assert_array_equal(a.flow, b.flow)
    assert (a.objective, sh.last_supersteps) == (b.objective, cs.last_supersteps)


def test_a_type_error_in_a_solve_does_not_step_down(group):
    """A solver whose tensors stray from its mesh's device raises
    TypeError at its first collective; the ladder re-raises it and never
    builds a lower rung."""
    from ksched_tpu_torch.parallel.mesh import ShardMesh
    from ksched_tpu_torch.parallel.sharded_solver import ShardedJaxSolver
    from ksched_tpu_torch.runtime.degrade import build_degradation_ladder

    mesh = ShardMesh(None, device="cpu")
    solver = ShardedJaxSolver(mesh, telemetry=0)  # its tensors on the CPU
    mesh.device = torch.device("meta")  # the mesh now expects another device
    built = []

    def make_backend(name, device):  # pragma: no cover - must not be reached
        built.append(name)
        raise AssertionError(f"the ladder built its {name!r} rung")

    ladder = build_degradation_ladder(solver, "sharded", make_backend=make_backend,
                                      device="cpu")
    with pytest.raises(TypeError, match="mesh on meta"):
        ladder.solve(_problem())
    assert built == []
    assert ladder.degradations_total == 0
    assert ladder.last_degradations == 0
