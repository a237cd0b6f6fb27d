"""Slice 11 on the card: the stacked lane solve, the tenancy layer, the
multi-tenant service, the tenant soak and the new cost models through
the service, each on cuda against the same run on the CPU, bit for bit.
Marked `cuda`; every test skips where no CUDA device is present.
Imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda_tenancy.py --noconftest -q
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ksched_tpu_torch.graph.device_export import FlowProblem  # noqa: E402
from ksched_tpu_torch.solver import csr_solver as tcs  # noqa: E402
from torch_tenancy_cells import BUCKETS, ToyCell, lane_inputs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _bits(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a, b))


@pytest.mark.parametrize("tel", [0, 8])
@pytest.mark.parametrize("warm", [False, True])
def test_stacked_solve_on_the_card_equals_the_cpu(card, tel, warm):
    rng = np.random.default_rng(11)
    cells = [ToyCell(40 + i, 128, 256, *BUCKETS[i % 3][2:]) for i in range(4)]
    lanes = [lane_inputs(c, tcs.build_csr_plan, rng if i == 1 else None)
             for i, c in enumerate(cells)]
    cols = [np.stack([ln[i] for ln in lanes]) for i in range(4)]
    plan = [np.stack([ln[4][i] for ln in lanes]) for i in range(10)]
    head = cols + [np.array([1, 1, int(np.abs(lanes[2][1]).max()), 1], np.int32)]
    if warm:
        head.append(rng.integers(-4000, 4000, (4, 128)).astype(np.int32))
    fn = tcs.stacked_solve_fn(use_warm_p=warm, telemetry_cap=tel)
    got = fn(*(torch.as_tensor(a, device=card) for a in head + plan))
    want = fn(*(torch.as_tensor(a) for a in head + plan))
    assert all(g.device.type == "cuda" for g in got)
    assert _bits(got, want)


def test_lanes_on_the_card_equal_the_cpu(card):
    from ksched_tpu_torch.tenancy import LaneSolver, StackedBatcher

    def run(dev):
        cells = [ToyCell(100 + i, *BUCKETS[i % 3]) for i in range(5)]
        batcher = StackedBatcher(device=dev)
        lanes = [LaneSolver(batcher, tenant=f"t{i}", restart_budget=64, telemetry=8,
                            device=dev) for i in range(5)]
        out = []
        for r in range(4):
            if r:
                for i, c in enumerate(cells):
                    c.churn("endpoint" if i == 0 else "cost")
            pend = [ls.solve_async(c.problem(FlowProblem)) for ls, c in zip(lanes, cells)]
            batcher.flush()
            for ls, p in zip(lanes, pend):
                res = ls.complete(p)
                out.append((res.flow.tolist(), res.objective, ls.last_supersteps,
                            ls.last_warm_scope, np.asarray(ls.last_telemetry.rows).tolist()))
        return out

    assert run(card) == run("cpu")


def _fleet(dev, resident=False):
    from ksched_tpu_torch.cluster import PodEvent
    from ksched_tpu_torch.obs.metrics import Registry
    from ksched_tpu_torch.runtime.chaos import ChaosPolicy, FaultInjector
    from ksched_tpu_torch.tenancy import MultiTenantService

    mts = MultiTenantService(registry=Registry(), pipeline=True, device_resident=resident,
                             device=dev)
    cells = {}
    for tid in ("a", "b", "c"):
        inj = (FaultInjector(ChaosPolicy(seed=3, solver_fault_prob=0.5,
                                         solver_total_outage_prob=0.3))
               if tid == "a" else None)
        cells[tid] = mts.add_tenant(tid, machines=3, pus_per_core=2, slots=4,
                                    seed=sum(map(ord, tid)), injector=inj)
    rngs = {t: np.random.default_rng(sum(map(ord, t))) for t in cells}
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(6):
            for t, c in cells.items():
                for j in range(int(rngs[t].integers(0, 3))):
                    c.api.submit_pod(PodEvent(pod_id=f"{t}_p{r}_{j}"))
            mts.run_round(now=float(r))
        mts.drain()
    return {t: (dict(c.api.bindings()),
                [(x.solver_work, x.solver_rung, x.noop_round) for x in c.svc.tracer.records])
            for t, c in cells.items()}


@pytest.mark.parametrize("resident", [False, True])
def test_multi_tenant_service_on_the_card_equals_the_cpu(card, resident):
    assert _fleet(card, resident) == _fleet("cpu", resident)


def test_tenant_soak_on_the_card_equals_the_cpu(card):
    from ksched_tpu_torch.drivers.multitenant import package
    from ksched_tpu_torch.drivers.soak import run_tenant_soak, tenant_soak_summary

    args = argparse.Namespace(tenants=4, rounds=12, seed=0, chaos_tenant=0)
    quiet = lambda *a, **k: None  # noqa: E731
    got = tenant_soak_summary(run_tenant_soak(package(card), args, quiet))
    want = tenant_soak_summary(run_tenant_soak(package("cpu"), args, quiet))
    assert got == want and got["checked"] == 3


@pytest.mark.parametrize("model", ["random", "sjf", "coco", "octopus", "void", "net"])
def test_policy_service_on_the_card_equals_the_cpu(card, model):
    from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service

    cfg = ServiceConfig(machines=6, pus_per_core=2, slots=4, pods=40, rounds=3, churn=0.1,
                        arrivals=8, cost_model=model, classes=4 if model == "coco" else 1)
    keep = ("bound", "placed", "path", "solver_work", "sha256")
    got = [[r[k] for k in keep] for r in run_service(package(card), cfg)["rounds"]]
    want = [[r[k] for k in keep] for r in run_service(package("cpu"), cfg)["rounds"]]
    assert got == want


def test_multi_tenant_service_needs_the_card_it_asks_for(card, monkeypatch):
    from ksched_tpu_torch.tenancy import MultiTenantService

    assert MultiTenantService().device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiTenantService()
