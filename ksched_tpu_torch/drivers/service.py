"""Drive a SchedulerService round by round on a fabricated cluster.

The service half of BASELINE's round: pods arrive through a
SyntheticClusterAPI, the hardened loop (cli.SchedulerService.run_round)
schedules them, and a seeded share of the bound pods completes between
rounds while new pods arrive. Each round's record carries what a run is
held to: the pods bound, the live placements' count and sha256 (pod
name → node name, so ids drawn from the global id stream do not enter
it), and the AutoSolver path that solved it.

`run_service` takes the package as a namespace of its classes
(`package()` builds this one's) and uses only the API the two packages
share, so the same code drives ksched_tpu's SchedulerService in the
reference script (tests/torch_service_reference.py) and this package's
on the card.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def live_placements(svc) -> Dict[str, str]:
    """pod name -> node name of every bound task."""
    out = {}
    for tid, pu in svc.scheduler.task_bindings.items():
        pod = svc.task_to_pod.get(tid)
        mid = svc._find_parent_machine(pu)
        if pod is not None and mid is not None:
            out[pod] = svc.machine_to_node[mid]
    return out


def placements_sha256(placements: Dict[str, str]) -> str:
    return hashlib.sha256(
        json.dumps(sorted(placements.items())).encode()).hexdigest()


def solve_path(svc) -> Optional[str]:
    """The AutoSolver path of the last solve (None for other backends)."""
    backend = svc.scheduler.solver.backend
    primary = getattr(backend, "primary", backend)
    return getattr(primary, "last_path", None)


def _submit(api, pod_event, first: int, count: int, classes: int,
            rng: np.random.Generator) -> None:
    """Submit pods pod_<first> .. pod_<first + count - 1>; with
    ``classes`` > 1 each draws its task class from `rng`."""
    for i in range(first, first + count):
        cls = int(rng.integers(0, classes)) if classes > 1 else 0
        api.submit_pod(pod_event(pod_id=f"pod_{i}", task_class=cls))


def _complete_share(svc, rng: np.random.Generator, share: float) -> None:
    """Complete max(1, share x bound) of the bound pods, drawn by `rng`
    over their sorted names."""
    bound = sorted(p for p, t in svc.pod_to_task.items()
                   if t in svc.scheduler.task_bindings)
    if bound:
        k = max(1, int(len(bound) * share))
        for j in sorted(int(x) for x in rng.choice(len(bound), k, replace=False)):
            svc.complete_pod(bound[j])


@dataclass(frozen=True)
class ServiceConfig:
    """One service run: a fabricated cluster of `machines` x 1 core x
    `pus_per_core` PUs x `slots` slots, `pods` pods in the first round,
    then `rounds` rounds of `churn` completions and `arrivals` pods.

    ``corrupt_prob`` > 0 hands the service a FaultInjector whose only
    faults are device-tensor bit flips drawn per solve at that
    probability (seeded by `seed`); ``restore_after`` = r checkpoints
    the service after round r and goes on with the restored one."""

    machines: int = 1000
    pus_per_core: int = 4
    slots: int = 4
    pods: int = 10_000
    rounds: int = 4
    churn: float = 0.01
    arrivals: int = 100
    seed: int = 1
    classes: int = 1
    cost_model: str = "trivial"
    backend: str = "auto"
    pipeline: bool = False
    device_resident: bool = False
    audit_every: int = 0
    corrupt_prob: float = 0.0
    restore_after: Optional[int] = None


#: one configuration per host cost model beyond Trivial, Quincy and
#: Whare-Map, at BASELINE's round: the one-shot and a round of 1%
#: completions and 100 arrivals through "auto" (CoCo with four task
#: classes, as service-whare).
#: Random is cut to 200 pods on 20 machines: every task is a class of
#: its own, and the dense solve needs 35,568 supersteps at that size
#: already (the JAX package's CPU run at full size did not end in 10
#: minutes)
POLICY_CONFIGS = {
    f"policy-{m}": ServiceConfig(cost_model=m, rounds=1, classes=4 if m == "coco" else 1,
                                 **(dict(machines=20, pods=200) if m == "random" else {}))
    for m in ("random", "sjf", "coco", "octopus", "void", "net")
}


def run_service(pkg, cfg: ServiceConfig) -> dict:
    """Run `cfg` through package `pkg`, a namespace holding its
    SchedulerService, SyntheticClusterAPI, PodEvent, CostModelType,
    RoundTracer, FaultInjector, ChaosPolicy and seed_rng, a
    ``make_backend(name)`` and the ``service_kw`` its SchedulerService
    takes besides the config's (the port's `device`).

    Returns {"rounds": a record a round (the pods bound, the live
    placements' count and sha256, the AutoSolver path, the RoundRecord
    phases in ms and solver work, the bit flips injected and the
    divergences the audit found), "restored_warm": None, or whether the
    restore took the warm manifest, and "service": the last service}."""
    pkg.seed_rng(cfg.seed)
    api = pkg.SyntheticClusterAPI(
        pod_chan_size=cfg.pods + cfg.rounds * cfg.arrivals + 1)
    injector = None
    if cfg.corrupt_prob:
        injector = pkg.FaultInjector(pkg.ChaosPolicy(
            seed=cfg.seed, device_corrupt_prob=cfg.corrupt_prob))
    tracer = pkg.RoundTracer()
    kw = dict(
        cost_model=pkg.CostModelType[cfg.cost_model.upper()],
        backend_name=cfg.backend, injector=injector, tracer=tracer,
        pipeline=cfg.pipeline, device_resident=cfg.device_resident,
        audit_every=cfg.audit_every, **pkg.service_kw)
    svc = pkg.SchedulerService(api, max_tasks_per_pu=cfg.slots,
                               backend=pkg.make_backend(cfg.backend), **kw)
    svc.init_topology(fake_machines=cfg.machines, pus_per_core=cfg.pus_per_core)
    out = {"restored_warm": None, "service": svc, "rounds": []}
    seen = {"flips": 0, "div": 0, "div_before": 0}
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0x5E7]))
    rng_cls = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC1A55]))
    _submit(api, pkg.PodEvent, 0, cfg.pods, cfg.classes, rng_cls)
    seq = cfg.pods
    for r in range(cfg.rounds + 1):
        if r:
            _complete_share(svc, rng, cfg.churn)
            _submit(api, pkg.PodEvent, seq, cfg.arrivals, cfg.classes, rng_cls)
            seq += cfg.arrivals
        bound = svc.run_round(api.poll_pod_batch(0.005))
        svc.flush_pending_bindings()
        placements = live_placements(svc)
        last = tracer.records[-1]
        flips = injector.counters.get("device_bit_flip", 0) if injector else 0
        div = seen["div_before"] + svc.scheduler.solver.integrity_counts.get(
            "divergences", 0)
        out["rounds"].append({
            "bound": int(bound),
            "placed": len(placements),
            "path": solve_path(svc),
            "sha256": placements_sha256(placements),
            "phases_ms": dict(last.phases_ms),
            "solver_work": int(last.solver_work),
            "flips": flips - seen["flips"],
            "divergences": div - seen["div"],
        })
        seen["flips"], seen["div"] = flips, div
        if cfg.restore_after == r:
            seen["div_before"] = div  # the restored solver counts from 0
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "svc.ckpt")
                svc.save_checkpoint(path)
                svc = pkg.SchedulerService.restore(
                    api, path, backend=pkg.make_backend(cfg.backend), **kw)
            out["restored_warm"] = bool(svc.restored_warm)
            out["service"] = svc
    return out


def package(device="cuda"):
    """This package as `run_service` takes it, its solves on `device`."""
    from types import SimpleNamespace

    from ..cli import SchedulerService
    from ..cluster import PodEvent, SyntheticClusterAPI
    from ..costmodels import CostModelType
    from ..runtime import ChaosPolicy, FaultInjector, RoundTracer
    from ..solver.select import make_backend
    from ..utils import seed_rng

    return SimpleNamespace(
        SchedulerService=SchedulerService, SyntheticClusterAPI=SyntheticClusterAPI,
        PodEvent=PodEvent, CostModelType=CostModelType, RoundTracer=RoundTracer,
        FaultInjector=FaultInjector, ChaosPolicy=ChaosPolicy, seed_rng=seed_rng,
        make_backend=lambda name: make_backend(name, device=device),
        service_kw={"device": device})
