"""The JAX package's values for chip_smoke.py's policies phase.

Runs ksched_tpu's SchedulerService on the CPU through the driver the
smoke runs on the card (ksched_tpu_torch/drivers/service.py), one
configuration per host cost model beyond Trivial, Quincy and
Whare-Map (POLICY_CONFIGS), at BASELINE's round (10k pods on 1,000
fabricated machines x 4 PUs x 4 slots, through make_backend("auto");
Random cut to 200 pods on 20 machines), and prints each round's pods bound, placements' count and
sha256, AutoSolver path and solver work:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_policy_reference.py [name ...]

Names: policy-random, policy-sjf, policy-coco, policy-octopus,
policy-void, policy-net (default: all).
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from ksched_tpu_torch.drivers.service import POLICY_CONFIGS, run_service  # noqa: E402
from torch_service_reference import jax_package  # noqa: E402

KEEP = ("bound", "placed", "path", "solver_work", "sha256")


def policy_values(name: str) -> list:
    got = run_service(jax_package(), POLICY_CONFIGS[name])
    return [[r[k] for k in KEEP] for r in got["rounds"]]


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(POLICY_CONFIGS)
    warnings.simplefilter("ignore")
    for name in names:
        t0 = time.perf_counter()
        rows = policy_values(name)
        print(json.dumps({name: rows}), flush=True)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
