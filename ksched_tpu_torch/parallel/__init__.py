"""The multi-device rung: the sharded scan-CSR solve, the sharded layered
transport and batched what-if solves, SPMD over a torch.distributed
process group (`ShardMesh`). Port of ksched_tpu/parallel/."""

from .mesh import ShardMesh
from .sharded_solver import (
    ShardedJaxSolver,
    ShardedPlan,
    build_sharded_plan,
    make_sharded_slot_solver,
    make_sharded_solver,
    scan_csr_fits_hbm,
    sharded_fits_hbm,
    sharded_plan_apply_fn,
    sharded_plan_fingerprint_fn,
)
from .sharded_transport import ShardedLayeredSolver, sharded_transport_solve
from .whatif import (
    ScenarioBatchResult,
    WhatIfSolver,
    drain_scenarios,
    surge_scenarios,
)

__all__ = [
    "ShardMesh",
    "ShardedJaxSolver",
    "ShardedLayeredSolver",
    "sharded_transport_solve",
    "ShardedPlan",
    "build_sharded_plan",
    "make_sharded_solver",
    "make_sharded_slot_solver",
    "scan_csr_fits_hbm",
    "sharded_fits_hbm",
    "sharded_plan_apply_fn",
    "sharded_plan_fingerprint_fn",
    "ScenarioBatchResult",
    "WhatIfSolver",
    "drain_scenarios",
    "surge_scenarios",
]
