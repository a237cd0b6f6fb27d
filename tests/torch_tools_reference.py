"""The JAX package's values for chip_smoke.py's tool phases.

Runs ksched_tpu's tools (tools/soak.py's device soak, tools/tail_repro.py
capture and replays, tools/shard_smoke.py's arms) on the CPU at the
smoke's arguments and prints the values the smoke holds the port's
tools to (chip_smoke.py REF_TOOLS):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_tools_reference.py [name ...]

Names: soak, tails, profile, shard (default: all). The shard arms run on 2
virtual devices (it sets XLA_FLAGS itself).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

#: the smoke's device soak: tools/soak.py's 20,000 tasks on 500
#: machines, --preempt, 512 rounds in chunks of 128, a checkpoint round
#: trip every 2 chunks
SOAK = ["--tasks", "20000", "--machines", "500", "--preempt", "--rounds", "512",
        "--chunk", "128", "--checkpoint-every", "2"]

#: the smoke's captures (tools/tail_repro.py's full configs): rounds and
#: thresholds that keep two or three tails, and each capture's replay
TAILS = {
    "whare": dict(rounds=60, threshold=40, replay="replay", alpha="2,8", refine="8,32"),
    "coco-preempt": dict(rounds=4, threshold=5000, replay="replay-tiered", refine="0,8"),
    "quincy": dict(rounds=4, threshold=280, replay="replay-grouped",
                   strategies="two:1:256,two:n4:1024,full:n4:2,full:n:2"),
}

#: tools/profile_round.py's geometry, chain length and repetitions
PROFILE = dict(M=1000, P=4, S=4, J=10, T=10_000, Tcap=16384, R=64, reps=7)

#: the Makefile's shard-smoke arguments on D = 2 ranks
SHARD = dict(machines=6, tasks=48, rounds=24, warmup=4, seed=7, devices=2)


def stdout_of(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue().splitlines()


def npz_sha256(path) -> dict:
    """sha256 of each array of an npz, by key (dtype and shape included)."""
    data = np.load(path)
    return {k: hashlib.sha256(
        f"{data[k].dtype}{data[k].shape}".encode() + np.ascontiguousarray(data[k]).tobytes()
    ).hexdigest() for k in sorted(data.files)}


def replay_args(spec: dict, path: str) -> argparse.Namespace:
    kw = {k: v for k, v in spec.items() if k in ("alpha", "refine", "strategies")}
    return argparse.Namespace(inst=path, device="cpu", **kw)


def jax_soak(argv=SOAK) -> list:
    """tools/soak.py --cpu's chunk lines (its SOAK OK line left out)."""
    from tools import soak as jsoak

    old = sys.argv
    sys.argv = ["soak.py", "--cpu", *argv]
    try:
        lines = stdout_of(jsoak.main)
    finally:
        sys.argv = old
    assert lines[-1].startswith("SOAK OK: ")
    return lines[:-1]


def jax_tails(names=tuple(TAILS)) -> dict:
    """Per config: the capture line, the npz arrays' sha256 and the
    replay's lines."""
    from tools import tail_repro as jtail

    replays = {"replay": jtail.replay, "replay-tiered": jtail.replay_tiered,
               "replay-grouped": jtail.replay_grouped}
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for name in names:
            spec = TAILS[name]
            path = os.path.join(td, f"{name}.npz")
            cap = argparse.Namespace(config=name, rounds=spec["rounds"], warmup=0,
                                     threshold=spec["threshold"], out=path, verbose=False)
            lines = stdout_of(jtail.capture, cap)
            out[name] = {"capture": lines[0], "npz_sha256": npz_sha256(path),
                         "replay": stdout_of(replays[spec["replay"]],
                                             replay_args(spec, path))}
    return out


def jax_profile(M, P, S, J, T, Tcap, R, reps) -> list:
    """tools/profile_round.py's round sequence in the JAX package (the
    fill, a warm-up chain of R steady rounds at seed 1, then `reps`
    chains at seeds 2, 3, ...): each timed chain's stats sha256."""
    from ksched_tpu.scheduler.device_bulk import DeviceBulkCluster
    from ksched_tpu_torch.drivers.device_bulk import stats_sha256

    rng = np.random.default_rng(0)
    dev = DeviceBulkCluster(num_machines=M, pus_per_machine=P, slots_per_pu=S,
                            num_jobs=J, task_capacity=Tcap)
    dev.add_tasks(T, rng.integers(0, J, T).astype(np.int32))
    assert bool(dev.fetch_stats(dev.round())["converged"])
    churn_n = max(1, T // 100)
    dev.run_steady_rounds(R, 0.01, churn_n, seed=1)
    return [stats_sha256(dev.fetch_stats(dev.run_steady_rounds(R, 0.01, churn_n, seed=2 + i)))
            for i in range(reps)]


def jax_shard(machines, tasks, rounds, warmup, seed, devices) -> dict:
    """tools/shard_smoke.py's three arms on `devices` virtual devices,
    with the values ksched_tpu_torch/tools/shard_smoke.py run_smoke
    returns (its own asserts held)."""
    import warnings

    import jax
    from jax.sharding import Mesh

    from ksched_tpu.parallel.sharded_solver import ShardedJaxSolver
    from ksched_tpu.runtime.chaos import ChaosPolicy, FaultInjector
    from ksched_tpu.runtime.degrade import build_degradation_ladder
    from ksched_tpu.solver.jax_solver import JaxSolver
    from ksched_tpu_torch.tools.shard_smoke import placements_sha256
    from tools import shard_smoke as jsmoke

    mesh = Mesh(np.array(jax.devices()[:devices]), ("x",))
    common = dict(machines=machines, tasks=tasks, rounds=rounds, warmup=warmup)
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        ref_pl, ref_kinds, _, _, _ = jsmoke._drive_arm(
            "scan-csr", JaxSolver(slot_stable=True, restart_budget=64),
            plan_shards=devices, **common)
        sharded = ShardedJaxSolver(mesh)
        sh_pl, sh_kinds, _, _, _ = jsmoke._drive_arm(
            "sharded", sharded, resident_mesh=mesh, **common)

        def chaos_run():
            injector = FaultInjector(ChaosPolicy(seed=seed, solver_fault_prob=0.25))
            ladder = build_degradation_ladder(ShardedJaxSolver(mesh), "sharded",
                                              injector=injector)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                pl, _, _, _, rungs = jsmoke._drive_arm("chaos", ladder, injector=injector,
                                                       **common)
            return pl, ladder.degradations_total, injector.snapshot(), rungs

        pl_a, degr_a, snap_a, rungs_a = chaos_run()
        pl_b, degr_b, snap_b, _ = chaos_run()
    assert ref_pl == sh_pl and pl_a == pl_b and (degr_a, snap_a) == (degr_b, snap_b)
    return {
        "scan_csr": {"placements_sha256": placements_sha256(ref_pl),
                     "kinds": dict(sorted(ref_kinds.items()))},
        "sharded": {"placements_sha256": placements_sha256(sh_pl),
                    "kinds": dict(sorted(sh_kinds.items()))},
        "chaos": {"placements_sha256": placements_sha256(pl_a), "degradations": degr_a,
                  "faults": dict(sorted(snap_a.items())),
                  "rungs": dict(sorted(rungs_a.items()))},
    }


def main() -> int:
    names = sys.argv[1:] or ["soak", "tails", "profile", "shard"]
    out = {"args": {"soak": SOAK, "tails": TAILS, "profile": PROFILE, "shard": SHARD}}
    if "soak" in names:
        out["soak"] = jax_soak()
    if "tails" in names:
        out["tails"] = jax_tails()
    if "profile" in names:
        out["profile"] = jax_profile(**PROFILE)
    if "shard" in names:
        out["shard"] = jax_shard(**SHARD)
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
