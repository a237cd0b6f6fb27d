"""ksched_tpu_torch.tenancy: scheduler-as-a-service — one warm solver
process, N independent cells.

The ROADMAP's "millions of users" story is N independent clusters
multiplexed through one warm device-resident solver process. A flow
network is block-diagonal across tenants — independent components never
interact — so same-bucket tenants batch through ONE stacked
solve (solver/csr_solver.stacked_solve_fn) while everything that must
stay isolated stays isolated: graph state, warm flow/potentials,
restart budgets, the degradation ladder, chaos faults, accounting, and
flight recordings are all per-tenant.

Three layers:

- **batch** — `LaneSolver` (the per-tenant FlowSolver front-end,
  mirroring CsrSolver's journal-scoped warm policy bit for bit) and
  `StackedBatcher` (parks lanes, groups them by shape bucket + solve
  policy, runs one stacked solve per group, escalates failed
  lanes per-lane);
- **manager** — `TenantManager`: admission control, pow2 bucket/lane
  assignment, fairness rotation, and quarantine for tenants whose
  lanes repeatedly blow their budgets;
- **service** — `MultiTenantService`: N `SchedulerService` cells (one
  ClusterAPI adapter each) driven through a four-phase round — dispatch
  every cell, flush the shared batch, post the previous round's
  bindings per tenant inside the batched-solve window, complete every
  cell — with per-tenant round deadlines, degradation ladders, scoped
  metrics (`tenant` label), flight recorders, and soltel stall
  attribution.

Port of ksched_tpu/tenancy. The stacked solve is plain PyTorch on the
lanes' device (the JAX package's is XLA, not Pallas): no kernel.
"""

from .batch import LaneSolver, StackedBatcher
from .manager import AdmissionError, AdmissionPolicy, TenantManager
from .service import MultiTenantService, TenantCell

__all__ = [
    "AdmissionError",
    "AdmissionPolicy",
    "LaneSolver",
    "MultiTenantService",
    "StackedBatcher",
    "TenantCell",
    "TenantManager",
]
