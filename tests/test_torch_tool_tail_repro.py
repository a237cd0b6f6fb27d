"""ksched_tpu_torch/tools/tail_repro.py against ksched_tpu's
tools/tail_repro.py on the CPU, tolerance 0: `instance_from_state` and
`grouped_instance_from_state` on a state carried across by interop; the
capture loop's npz arrays; every replay point of `replay`,
`replay-tiered` and `replay-grouped` (supersteps, convergence,
objective or its drift flag, as the tools print them) on the same npz;
and an npz written by either tool replaying in the other. The configs
are the tool's own, cut to 40 machines (tools/tail_repro.py's
`build_config` is swapped for the cut one in the JAX tool)."""

import argparse
import contextlib
import io

import numpy as np
import pytest

from tools import tail_repro as jtail
from torch_tools_cases import small_config

from ksched_tpu_torch.tools import tail_repro as ttail


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue().splitlines()


def _quiet(*a, **k):
    pass


def jax_capture(monkeypatch, name, path, rounds, threshold):
    """The JAX tool's own capture() on the cut config."""
    def build(_name):
        dev, tasks, groups = small_config("jax", name)
        if groups is not None:
            dev._tail_repro_groups = (None, groups)
        return dev, tasks

    monkeypatch.setattr(jtail, "build_config", build)
    args = argparse.Namespace(config=name, rounds=rounds, warmup=0, threshold=threshold,
                              out=str(path), verbose=False)
    return _stdout(jtail.capture, args)


def torch_capture(name, path, rounds, threshold):
    dev, tasks, groups = small_config("torch", name)
    lines = []
    insts, ss_all = ttail.capture_rounds(dev, tasks, rounds, threshold, groups=groups,
                                         log=_quiet)
    lines.append(ttail.capture_summary(ss_all, threshold, len(insts)))
    out = ttail.instances_npz(dev, insts, groups is not None)
    np.savez_compressed(str(path), **out)
    return lines, out


#: (config, rounds, threshold, replay): each config's capture, two or
#: three of its rounds kept, and its replay
CASES = [("whare", 3, 1, "replay"), ("coco-preempt", 6, 300, "replay-tiered"),
         ("quincy", 3, 1, "replay-grouped")]


def _replay_args(kind, path):
    if kind == "replay":
        return argparse.Namespace(inst=str(path), alpha="2,8", refine="0,8", device="cpu")
    if kind == "replay-tiered":
        return argparse.Namespace(inst=str(path), refine="8", device="cpu")
    return argparse.Namespace(inst=str(path), device="cpu",
                              strategies="two:1:256,two:n4:1024,full:n4:2,full:n:2")


_JAX_REPLAY = {"replay": jtail.replay, "replay-tiered": jtail.replay_tiered,
               "replay-grouped": jtail.replay_grouped}
_TORCH_REPLAY = {"replay": ttail.replay, "replay-tiered": ttail.replay_tiered,
                 "replay-grouped": ttail.replay_grouped}


@pytest.mark.parametrize("name,rounds,threshold,kind", CASES, ids=[c[0] for c in CASES])
def test_capture_and_replay_match_the_jax_tool(monkeypatch, tmp_path, name, rounds,
                                               threshold, kind):
    j_path, t_path = tmp_path / "jax.npz", tmp_path / "torch.npz"
    j_lines = jax_capture(monkeypatch, name, j_path, rounds, threshold)
    t_lines, _out = torch_capture(name, t_path, rounds, threshold)
    assert t_lines[0] == j_lines[0]
    j_npz, t_npz = np.load(j_path), np.load(t_path)
    assert sorted(j_npz.files) == sorted(t_npz.files)
    for key in j_npz.files:
        assert j_npz[key].dtype == t_npz[key].dtype, key
        np.testing.assert_array_equal(j_npz[key], t_npz[key], err_msg=key)
    assert int(t_npz["n"]) >= 2
    # every replay point of the port on the JAX tool's npz, and of the
    # JAX tool on the port's
    want = _stdout(_JAX_REPLAY[kind], _replay_args(kind, j_path))
    got = []
    res = _TORCH_REPLAY[kind](_replay_args(kind, j_path), lambda s, **k: got.append(s))
    assert got == want
    assert len(res) == int(t_npz["n"]) and all(r["points"] for r in res)
    assert _stdout(_JAX_REPLAY[kind], _replay_args(kind, t_path)) == want
    if kind == "replay":
        argv = ["--device", "cpu", "replay", "--inst", str(j_path), "--alpha", "2,8",
                "--refine", "0,8"]
        assert _stdout(ttail.main, argv) == want


@pytest.mark.parametrize("name", ["whare", "coco-preempt", "quincy"])
def test_instance_from_state_matches_the_jax_tool(name):
    from ksched_tpu_torch import interop

    jdev, tasks, groups = small_config("jax", name)
    tdev, _tasks, _groups = small_config("torch", name)
    rng = np.random.default_rng(3)
    if groups is not None:
        jdev.add_tasks(tasks, rng.integers(0, jdev.J, tasks).astype(np.int32), groups=groups)
    else:
        jdev.add_tasks(tasks, rng.integers(0, jdev.J, tasks).astype(np.int32),
                       rng.integers(0, jdev.C, tasks).astype(np.int32))
    jdev.fetch_stats(jdev.round())
    # a backlog: admissions after the fill round, one machine down
    n = 64
    if groups is not None:
        jdev.add_tasks(n, rng.integers(0, jdev.J, n).astype(np.int32),
                       groups=rng.integers(0, jdev.G, n).astype(np.int32))
    else:
        jdev.add_tasks(n, rng.integers(0, jdev.J, n).astype(np.int32),
                       rng.integers(0, jdev.C, n).astype(np.int32))
    jdev.set_machine_enabled(3, False)
    st = {k: np.asarray(v) for k, v in jdev.fetch_state().items()}
    interop.continue_cluster(tdev, st)
    tst = tdev.fetch_state()
    if groups is not None:
        want = jtail.grouped_instance_from_state(jdev, st)
        got = ttail.grouped_instance_from_state(tdev, tst)
    else:
        want = jtail.instance_from_state(jdev, st)
        got = ttail.instance_from_state(tdev, tst)
    assert len(got) == len(want) == (4 if name == "coco-preempt" else
                                     2 if name == "quincy" else 3)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("name", ["whare", "coco", "coco-preempt", "quincy", "multiblock"])
def test_build_config_matches_the_jax_tool(name):
    """The full configs built on the CPU (no round run): geometry, knobs,
    and in group mode the GroupSpec arrays and the initial groups, equal
    to the JAX tool's build_config."""
    jdev, jtasks = jtail.build_config(name)
    tdev, tasks, groups = ttail.build_config(name, device="cpu")
    assert tasks == jtasks
    for attr in ("M", "P", "S", "J", "C", "G", "Tcap", "Mp", "n_scale", "unsched_cost",
                 "ec_cost", "supersteps", "decode_width", "preemption",
                 "continuation_discount", "active_groups_caps", "two_stage_eps0"):
        assert getattr(tdev, attr) == getattr(jdev, attr), attr
    jgroups = getattr(jdev, "_tail_repro_groups", None)
    assert (groups is None) == (jgroups is None)
    if groups is not None:
        np.testing.assert_array_equal(groups, np.asarray(jgroups[1]))
        for field in ("cls", "job", "e", "u", "pref_w"):
            np.testing.assert_array_equal(getattr(tdev.groups, field).numpy(),
                                          np.asarray(getattr(jdev.groups, field)), field)
