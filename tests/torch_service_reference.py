"""The JAX package's values for chip_smoke.py's service phases.

Runs ksched_tpu's SchedulerService on the CPU through the same driver
the smoke runs on the card (ksched_tpu_torch/drivers/service.py), and
tools/soak.py's chaos soak at the smoke's arguments, and prints the
values the smoke holds the port to:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_service_reference.py [name ...]

Names: service, service-whare, service-resident, native, soak (default:
all).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import warnings
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from ksched_tpu_torch.drivers.service import ServiceConfig, run_service  # noqa: E402
from ksched_tpu_torch.drivers.soak import soak_summary  # noqa: E402

#: the smoke's configurations (BASELINE's round: 10k pods on 1,000
#: fabricated machines x 4 PUs x 4 slots)
CONFIGS = {
    "service": ServiceConfig(),
    "service-whare": ServiceConfig(cost_model="whare", classes=4, rounds=3),
    "service-resident": ServiceConfig(backend="jax", rounds=5, device_resident=True,
                                      audit_every=1),
    "service-resident-faults": ServiceConfig(backend="jax", rounds=5,
                                             device_resident=True, audit_every=1,
                                             corrupt_prob=0.5, restore_after=3),
    "native": ServiceConfig(backend="native", rounds=0),
}

#: the chaos soak arms (Makefile's chaos-smoke, and recovery-smoke cut
#: to 128 rounds with a restore every 48)
SOAKS = {
    "determinism": dict(rounds=96, chunk=32, seed=0, machines=6, slots=8,
                        chaos_restore_every=48, verify_determinism=True),
    "recovery": dict(rounds=128, chunk=32, seed=11, machines=6, slots=8,
                     chaos_restore_every=48, verify_recovery=True),
}


def soak_args(**kw) -> argparse.Namespace:
    d = dict(chaos_backend="jax", loop="sync", device_resident=False,
             corruption=False, wal_chaos=0.0, audit_every=0, verify_recovery=False,
             verify_loop_parity=False, verify_determinism=False, metrics_port=None,
             obs_out=None, flight_dir=None, assert_stall_flight=False,
             solver_outage_prob=None)
    d.update(kw)
    return argparse.Namespace(**d)


def jax_package():
    from ksched_tpu.cli import SchedulerService
    from ksched_tpu.cluster import PodEvent, SyntheticClusterAPI
    from ksched_tpu.costmodels import CostModelType
    from ksched_tpu.runtime import ChaosPolicy, FaultInjector, RoundTracer
    from ksched_tpu.solver.select import make_backend
    from ksched_tpu.utils import seed_rng

    return SimpleNamespace(
        SchedulerService=SchedulerService, SyntheticClusterAPI=SyntheticClusterAPI,
        PodEvent=PodEvent, CostModelType=CostModelType, RoundTracer=RoundTracer,
        FaultInjector=FaultInjector, ChaosPolicy=ChaosPolicy, seed_rng=seed_rng,
        make_backend=lambda name: make_backend(name, fallback=False),
        service_kw={})


def service_values(name: str) -> dict:
    got = run_service(jax_package(), CONFIGS[name])
    keep = ("bound", "placed", "path", "sha256", "solver_work", "flips", "divergences")
    return {"rounds": [{k: r[k] for k in keep} for r in got["rounds"]],
            "restored_warm": got["restored_warm"]}


def soak_values(name: str) -> dict:
    import soak as jsoak

    quiet = lambda *a, **k: None  # noqa: E731
    a = soak_args(**SOAKS[name])
    if name == "recovery":
        rec = copy.copy(a)
        rec.corruption, rec.device_resident = True, True
        ctl = copy.copy(a)
        ctl.corruption, ctl.audit_every, ctl.device_resident = False, 1, True
        ctl.chaos_restore_every, ctl.solver_outage_prob = 0, 0.0
        ctl.control_clean_policy = True
        return {"recovered": soak_summary(jsoak.run_chaos_soak(rec, quiet)),
                "control": soak_summary(jsoak.run_chaos_soak(ctl, quiet))}
    return {"run": soak_summary(jsoak.run_chaos_soak(a, quiet))}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or (
        list(CONFIGS) + [f"soak-{k}" for k in SOAKS])
    warnings.simplefilter("ignore")
    out = {}
    for name in names:
        if name.startswith("soak-"):
            out[name] = soak_values(name[len("soak-"):])
        else:
            out[name] = service_values(name)
        print(json.dumps({name: out[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
