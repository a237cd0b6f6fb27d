"""The JAX package's values for chip_smoke.py's tenancy phase.

Runs ksched_tpu's tenancy on the CPU through the drivers the smoke runs
on the card, and prints what the smoke holds the port to:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_tenancy_reference.py [name ...]

Names (default: all):
- multitenant: bench.py's `multitenant` at its own arguments (16 cells of
  3 sizes, 4 warm-up and 24 rounds, restart budget 64) through
  ksched_tpu_torch/drivers/multitenant.py `run_multitenant_bench`: per
  round the sha256 of every cell's placements, both arms' supersteps and
  the batched arm's stacked groups;
- fleet: 4 tenants of BASELINE's round (10k pods on 1,000 machines x 4
  PUs x 4 slots each), then 4 rounds of 1% completions and 100 arrivals
  (`run_tenant_fleet`): per round and tenant the pods bound, placements'
  count and sha256, supersteps, warm scope, ladder rung and NOOP flag;
- cli: cli.main --tenants 4 at that width with 5,000 pods a cell (the
  synthetic pod channel holds 5,000; the JAX package's --tenants fills
  it before its first round): each cell's bound count, the rounds and
  the batch flushes;
- soak: the Makefile's tenant-smoke (16 cells, 40 rounds, seed 0, chaos
  on cell 0) through ksched_tpu_torch/drivers/soak.py `run_tenant_soak`:
  its `tenant_soak_summary`.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import warnings
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ksched_tpu_torch.drivers.multitenant import (  # noqa: E402
    FleetConfig,
    run_multitenant_bench,
    run_tenant_fleet,
)
from ksched_tpu_torch.drivers.soak import run_tenant_soak, tenant_soak_summary  # noqa: E402

#: cli.main's arguments in the smoke (per cell: 1,000 machines x 4 PUs x
#: 4 slots, 5,000 pods)
CLI_ARGS = ["--tenants", "4", "--podgen", "20000", "-nm", "1000", "--pus-per-core", "4",
            "-mt", "4"]
#: the Makefile's tenant-smoke
SOAK_ARGS = dict(tenants=16, rounds=40, seed=0, chaos_tenant=0)


def jax_package():
    from ksched_tpu.cluster import PodEvent, SyntheticClusterAPI
    from ksched_tpu.drivers import add_job, build_cluster
    from ksched_tpu.drivers.synthetic import add_task_to_job
    from ksched_tpu.obs.metrics import Registry
    from ksched_tpu.runtime.chaos import ChaosPolicy, FaultInjector
    from ksched_tpu.solver.jax_solver import JaxSolver
    from ksched_tpu.tenancy import LaneSolver, MultiTenantService, StackedBatcher
    from ksched_tpu.utils import seed_rng
    from ksched_tpu.utils.ids import rng

    return SimpleNamespace(
        build_cluster=build_cluster, add_job=add_job, add_task_to_job=add_task_to_job,
        seed_rng=seed_rng, rng=rng, StackedBatcher=StackedBatcher, LaneSolver=LaneSolver,
        sequential=lambda budget: JaxSolver(slot_stable=False, restart_budget=budget),
        MultiTenantService=MultiTenantService, SyntheticClusterAPI=SyntheticClusterAPI,
        PodEvent=PodEvent, Registry=Registry, ChaosPolicy=ChaosPolicy,
        FaultInjector=FaultInjector, sync=lambda: None)


def bench_rows(got: dict) -> list:
    """Per round: [placements sha256, batched supersteps, sequential
    supersteps, stacked groups]."""
    return [[r["batched"]["sha256"], r["batched"]["supersteps"],
             r["sequential"]["supersteps"], r["batched"]["groups"]] for r in got["rounds"]]


FLEET_KEYS = ("bound", "placed", "sha256", "supersteps", "scope", "rung", "noop")


def fleet_rows(got: dict) -> list:
    """Per round: [stacked groups, {tenant: [bound, placed, sha256,
    supersteps, scope, rung, noop]}]."""
    return [[r["groups"], {t: [v[k] for k in FLEET_KEYS] for t, v in r["tenants"].items()}]
            for r in got["rounds"]]


def cli_values(cli_main, argv) -> dict:
    """cli.main's per-cell bound counts, rounds and batch flushes."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    lines = err.getvalue().splitlines()
    bound = {ln.split(":")[0]: int(ln.split()[1].split("=")[1])
             for ln in lines if ln.startswith("cell")}
    tail = [ln for ln in lines if ln.startswith("tenancy:") and "rounds" in ln][-1].split()
    return {"rc": rc, "bound": bound, "rounds": int(tail[1]), "flushes": int(tail[3])}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or ["multitenant", "fleet", "cli",
                                                              "soak"]
    warnings.simplefilter("ignore")
    for name in names:
        t0 = time.perf_counter()
        if name == "multitenant":
            val = bench_rows(run_multitenant_bench(jax_package()))
        elif name == "fleet":
            val = fleet_rows(run_tenant_fleet(jax_package(), FleetConfig()))
        elif name == "cli":
            from ksched_tpu.cli import main as jax_cli
            from ksched_tpu.obs.metrics import Registry, scoped_registry

            with scoped_registry(Registry()):
                val = cli_values(jax_cli, CLI_ARGS)
        elif name == "soak":
            val = tenant_soak_summary(run_tenant_soak(
                jax_package(), argparse.Namespace(**SOAK_ARGS), lambda *a, **k: None))
        else:
            raise SystemExit(f"unknown name {name!r}")
        print(json.dumps({name: val}), flush=True)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
