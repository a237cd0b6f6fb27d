"""Block-diagonal stacked-CSR batching: N tenant lanes, one program.

Independent flow components in a block-diagonal stack never interact:
lane i's nodes are its local ids offset by ``i * n_cap`` and its arc
slots by ``i * m_cap``, no arc crosses lanes, and every per-node
segment reduction stays inside its lane. The stacked arrays are that
flat block-diagonal problem reshaped ``[L, ...]`` — the shape the
stacked solve (solver/csr_solver.stacked_solve_fn) consumes, with a
convergence mask per lane. Each lane's solve is bit-identical to the
lane solved alone (flows, potentials, supersteps, telemetry rows).

Two classes:

- **LaneSolver** — the per-tenant FlowSolver front-end. It mirrors
  `CsrSolver`'s host-path warm policy exactly (journal-scoped warm
  restart, endpoint-masked warm flow, dirty-frontier price refit,
  budgeted restart escape), but instead of running its own solve
  it PARKS a lane request with the shared batcher and reads
  its lane's slice back at complete(). Escalations (price-war escape,
  cost-scaling fallback) run per-lane through the ordinary
  single-lane `_solve_mcmf` — a pathological tenant burns only its
  own budget, never another lane's wall-clock.
- **StackedBatcher** — the shared rendezvous. `flush()` groups parked
  lanes by (shape bucket, solve policy), pads each group to a pow2
  lane count (repeating a real lane — idempotent), stacks the arrays,
  and runs ONE stacked solve per group; lanes read their own slices
  at complete().

Lanes use the legacy tightly-packed `build_csr_plan` layout (per-lane
host argsort on endpoint churn, cached by `plan_key` on clean rounds);
a stacked slot-stable plan is future work. Device-resident tenants
still get delta-sized h2d: the per-tenant `DeviceResidentState`
buffers are consumed directly and stacked on the card.

Port of ksched_tpu/tenancy/batch.py. Lanes live on ``device`` ("cuda"
by default; it raises where there is no card). The stacked solve is
plain PyTorch, as the JAX package's is XLA: no kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph.device_export import FlowProblem, pad_problem, resident_solver_inputs
from ..obs.metrics import get_registry
from ..solver.base import FlowResult, FlowSolver, check_finite_costs, lower_bound_cost
from ..solver.csr_solver import (
    CsrPlan,
    _solve_mcmf,
    _solve_stacked,
    build_csr_plan,
    pad_lane_count,
    stacked_solve_fn,
)
from ..utils import next_pow2
from ..utils.device import resolve_device


class _LaneRequest:
    """One parked lane: the per-lane arrays of a stacked solve plus the
    slots the flush writes results into."""

    __slots__ = (
        "solver", "group_key", "dev_args", "flow0", "eps", "warm_p",
        "plan_args", "budget", "tel_cap", "use_warm_p", "outputs", "error",
    )

    def __init__(
        self, solver, group_key, dev_args, flow0, eps, warm_p, plan_args,
        budget, tel_cap, use_warm_p,
    ) -> None:
        self.solver = solver
        self.group_key = group_key
        self.dev_args = dev_args  # (cap, scaled cost, supply) per lane
        self.flow0 = flow0
        self.eps = eps
        self.warm_p = warm_p
        self.plan_args = plan_args  # 10-tuple, _solve_mcmf order
        self.budget = budget
        self.tel_cap = tel_cap
        self.use_warm_p = use_warm_p
        self.outputs: Optional[tuple] = None  # per-lane slices after flush
        self.error: Optional[BaseException] = None  # group dispatch failure


class StackedBatcher:
    """Shared across every tenant lane of one warm solver process.

    ``park()`` collects lane requests during the dispatch phase;
    ``flush()`` groups them by ``group_key`` — (n_cap, m_cap,
    use_warm_p, budget, telemetry cap, solo tag) — and dispatches one
    stacked program per group. Grouping by policy keeps the per-lane
    program IDENTICAL to the lane solved alone, which is what makes
    the bit-parity guarantee hold trivially; in steady state every
    same-bucket tenant is warm with the same budget, so a bucket is
    exactly one stacked call. A quarantined tenant's solo tag forces
    it into its own group: its lane still solves, but it can no longer
    stretch a shared solve's wall-clock.

    The stacked tensors live on ``device`` ("cuda" by default; it raises
    where there is no card). ``last_reads`` and ``last_supersteps`` are
    the last flush's host reads and each group's supersteps (the
    slowest lane's, the stack's own loop count).
    """

    def __init__(
        self,
        alpha: int = 8,
        max_supersteps: int = 50_000,
        tighten_sweeps: int = 32,
        device="cuda",
    ) -> None:
        self.alpha = alpha
        self.max_supersteps = max_supersteps
        self.tighten_sweeps = tighten_sweeps
        self.device = resolve_device(device)
        self._parked: List[_LaneRequest] = []
        self.flushes = 0
        self.last_groups = 0
        self.last_lanes = 0
        self.last_reads = 0
        self.last_supersteps: List[int] = []
        reg = get_registry()
        self._m_flushes = reg.counter(
            "ksched_tenant_batch_flushes_total",
            "stacked-batch flushes (one per multi-tenant round with work)",
        )
        self._m_groups = reg.counter(
            "ksched_tenant_batch_groups_total",
            "stacked programs dispatched, by why the group exists",
            labelnames=("kind",),
        )
        self._m_lanes = reg.histogram(
            "ksched_tenant_batch_lanes",
            "lanes per stacked program (pre lane-count padding)",
            buckets=tuple(float(1 << i) for i in range(11)),
        )

    def park(self, req: _LaneRequest) -> _LaneRequest:
        self._parked.append(req)
        return req

    def ensure(self, req: _LaneRequest) -> None:
        """Make sure a parked lane has outputs: flush if the caller
        completes before the service-level flush (sync loops, the
        degradation ladder's synchronous fallback, tests). A lane whose
        GROUP failed to dispatch re-raises that failure as a
        degradable RuntimeError — the tenant's own ladder steps down
        to its private jax/cpu_ref rungs, and the failure never
        propagates to lanes in other groups. A CUDA runtime failure
        re-raises as itself, which the ladder does not absorb
        (runtime/degrade.py is_kernel_failure)."""
        from ..runtime.degrade import is_kernel_failure

        if req.outputs is None and req.error is None:
            self.flush()
        if req.error is not None:
            if is_kernel_failure(req.error):
                raise req.error
            raise RuntimeError(
                f"stacked batch dispatch failed for group {req.group_key}: "
                f"{req.error}"
            ) from req.error
        if req.outputs is None:
            raise RuntimeError("lane request was never parked with this batcher")

    def flush(self) -> int:
        """Group parked lanes and run one stacked solve per group; each
        lane reads its slice at its own complete(). The solve's loop
        reads one flag a superstep, so the card's work is done when
        flush returns (the JAX package's flush dispatches
        asynchronously instead). Returns the number of stacked solves."""
        parked, self._parked = self._parked, []
        if not parked:
            return 0
        groups: Dict[tuple, List[_LaneRequest]] = {}
        reads0 = _solve_stacked.reads
        self.last_supersteps = []
        for req in parked:
            groups.setdefault(req.group_key, []).append(req)
        for key, reqs in groups.items():
            # per-GROUP fault barrier: a dispatch failure (a compile
            # error, device OOM on a new bucket's first jit, a shape
            # bug) marks only this group's lanes failed — their
            # complete() raises a degradable error and each affected
            # tenant's ladder steps down; other groups still solve,
            # and the fleet's split-round latches always clear
            try:
                self._flush_group(key, reqs)
            except Exception as e:  # noqa: BLE001 — re-raised per lane
                for req in reqs:
                    req.error = e
        self.flushes += 1
        self.last_groups = len(groups)
        self.last_lanes = len(parked)
        self.last_reads = _solve_stacked.reads - reads0
        self._m_flushes.inc()
        return len(groups)

    def _flush_group(self, key, reqs) -> None:
        lane_count = len(reqs)
        padded = pad_lane_count(lane_count)
        # idempotent lane padding: repeat a real lane; its outputs
        # are computed and discarded, so lane counts stay in pow2
        # buckets as the JAX package's executables do
        lanes = reqs + [reqs[0]] * (padded - lane_count)
        first = reqs[0]

        dev = self.device

        def stack(pick):
            # host lanes stack on host first (ONE upload per
            # column); device-resident lanes stack device-side
            cols = [pick(r) for r in lanes]
            if all(isinstance(c, (np.ndarray, np.generic)) for c in cols):
                return torch.as_tensor(np.stack(cols), device=dev)
            return torch.stack([torch.as_tensor(c, device=dev) for c in cols])

        args = [
            stack(lambda r, i=i: r.dev_args[i]) for i in range(3)
        ]
        args.append(stack(lambda r: r.flow0))
        args.append(stack(lambda r: r.eps))
        if first.use_warm_p:
            args.append(stack(lambda r: r.warm_p))
        args.extend(
            stack(lambda r, i=i: r.plan_args[i]) for i in range(10)
        )
        fn = stacked_solve_fn(
            alpha=self.alpha,
            max_supersteps=first.budget,
            tighten_sweeps=self.tighten_sweeps,
            telemetry_cap=first.tel_cap,
            use_warm_p=first.use_warm_p,
        )
        out = fn(*args)
        self.last_supersteps.append(int(out[2].max()))
        for i, req in enumerate(reqs):
            req.outputs = tuple(o[i] for o in out)
        self._m_groups.labels(
            kind="solo" if key[-1] is not None else (
                "warm" if first.use_warm_p else "fresh"
            )
        ).inc()
        self._m_lanes.observe(lane_count)


class LaneSolver(FlowSolver):
    """A tenant's lane into the shared stacked solve.

    The warm policy is `CsrSolver`'s (ksched_tpu's JaxSolver), verbatim:
    node potentials always carry (the batched solve REFITS them around
    the journal-dirty frontier via ``use_warm_p``), carried FLOW
    survives only rounds whose journal re-wired no endpoints
    (``plan_key`` match — the journal-scoped rule), and a warm attempt
    that blows ``restart_budget`` escapes to a fresh restart, then
    cost-scaling — both escalations run per-lane through the
    single-lane solve, so one tenant's price war cannot extend another
    tenant's round.

    ``bucket_floor=(n, m)`` pads this tenant's problems up to at least
    that pow2 bucket (graph/device_export.pad_problem). Bucket choice
    is strictly a per-tenant property: a lane's bucket never depends
    on which co-tenants share the process, so a tenant's solve in the
    multi-tenant batch is bit-identical to the same tenant solved in
    an isolated process with the same configuration.

    Its tensors live on ``device`` ("cuda" by default; it raises where
    there is no card), which must be the batcher's.
    """

    def __init__(
        self,
        batcher: StackedBatcher,
        tenant: str = "",
        warm_start: bool = True,
        warm_potentials: bool = True,
        restart_budget: Optional[int] = None,
        journal_scoped_warm: bool = True,
        telemetry: Optional[int] = None,
        bucket_floor: Optional[Tuple[int, int]] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        if self.device != batcher.device:
            raise TypeError(f"a lane on {self.device} with a batcher on "
                             f"{batcher.device}")
        self.batcher = batcher
        self.tenant = tenant
        self.warm_start = warm_start
        self.warm_potentials = warm_potentials
        self.restart_budget = restart_budget
        self.journal_scoped_warm = journal_scoped_warm
        self.telemetry = telemetry
        self.bucket_floor = bucket_floor
        #: manager-controlled: True forces this lane into its own
        #: stacked group (its pathology stops sharing wall-clock)
        self.quarantined = False
        self._prev: Optional[np.ndarray] = None
        self._prev_dev = None
        self._prev_p = None
        self._prev_src_dev = None
        self._prev_dst_dev = None
        self._prev_src_host: Optional[np.ndarray] = None
        self._prev_dst_host: Optional[np.ndarray] = None
        self._plan: Optional[CsrPlan] = None
        self._plan_dev: Optional[tuple] = None
        self._plan_key = None
        self._key_solved = None
        self.last_supersteps = 0
        self.last_telemetry = None
        self.last_warm_scope = "cold"
        #: True when the LAST solve's warm attempt blew its budget and
        #: escaped (the manager's quarantine signal)
        self.last_warm_escape = False
        self.warm_escapes_total = 0

    def reset(self) -> None:
        self._prev = None
        self._prev_dev = None
        self._prev_p = None
        self._prev_src_dev = None
        self._prev_dst_dev = None
        self._prev_src_host = None
        self._prev_dst_host = None
        self._key_solved = None

    # -- lane prep ---------------------------------------------------------

    def _bucket(self, n: int, m: int) -> Tuple[int, int]:
        n_cap = max(next_pow2(n), 16)
        m_cap = max(next_pow2(m), 16)
        if self.bucket_floor is not None:
            n_cap = max(n_cap, next_pow2(self.bucket_floor[0]))
            m_cap = max(m_cap, next_pow2(self.bucket_floor[1]))
        return n_cap, m_cap

    def _plan_for(self, src: np.ndarray, dst: np.ndarray, n: int, plan_key=None) -> tuple:
        """Per-lane legacy CSR plan, cached on the endpoint generation
        key exactly like CsrSolver._plan_for (clean rounds skip the
        O(M) scans entirely)."""
        plan = self._plan
        if plan_key is not None and self._plan_key == plan_key and plan is not None:
            return self._plan_dev
        if plan is None or len(plan.src) != len(src) or len(plan.node_first) != n or plan_key is not None or not (
            np.array_equal(plan.src, src) and np.array_equal(plan.dst, dst)
        ):
            plan = build_csr_plan(src, dst, n)
            self._plan = plan
            self._plan_dev = plan.tensors(self.device)
        self._plan_key = plan_key
        return self._plan_dev

    # -- FlowSolver --------------------------------------------------------

    def solve_async(self, problem: FlowProblem):
        """Build this round's lane request and PARK it with the shared
        batcher. The service loop flushes once for all tenants; a
        caller that completes first triggers the flush itself
        (StackedBatcher.ensure), so synchronous single-tenant use works
        unchanged."""
        orig = problem
        m0 = len(problem.src)
        if m0 == 0 or problem.num_arcs == 0:
            if (problem.excess > 0).any():
                raise RuntimeError("infeasible flow problem: supply but no arcs")
            return (orig, None, None)
        check_finite_costs(problem)
        n_cap, m_cap = self._bucket(problem.num_nodes, m0)
        resident = (
            getattr(problem, "d_cap", None) is not None
            and n_cap == problem.num_nodes
            and m_cap == m0
        )
        if n_cap != problem.num_nodes or m_cap != m0:
            problem = pad_problem(problem, n_cap, m_cap)
        src = np.asarray(problem.src, np.int32)
        dst = np.asarray(problem.dst, np.int32)
        max_cost = int(np.abs(problem.cost).max()) if m_cap else 0
        if max_cost * n_cap >= (1 << 30):
            raise OverflowError(
                f"scaled costs overflow int32: max|cost|={max_cost} at {n_cap} "
                "nodes; rescale cost-model outputs or shrink the lane bucket"
            )
        plan_key = getattr(problem, "plan_key", None)
        plan_args = self._plan_for(src, dst, n_cap, plan_key=plan_key)

        from ..obs import soltel

        tel_cap = soltel.resolve_cap(self.telemetry)
        # journal-scoped warm restart: identical rule to CsrSolver
        keep_flow = True
        if self.journal_scoped_warm and plan_key is not None:
            keep_flow = (
                self._key_solved is not None and plan_key == self._key_solved
            )
        if resident:
            dev_args, flow0, warm = resident_solver_inputs(
                problem, self._prev_dev, self._prev_src_dev,
                self._prev_dst_dev, self.warm_start and keep_flow, self.device,
            )
        else:
            cap = problem.cap.astype(np.int32)
            supply = problem.excess.astype(np.int32)
            cost = problem.cost.astype(np.int32) * np.int32(n_cap)
            dev_args = (cap, cost, supply)
            warm = (
                self.warm_start
                and keep_flow
                and self._prev is not None
                and len(self._prev) == m_cap
                and self._prev_src_host is not None
                and len(self._prev_src_host) == m_cap
            )
            flow0 = np.zeros(m_cap, dtype=np.int32)
            if warm:
                same = (self._prev_src_host == src) & (self._prev_dst_host == dst)
                if self.journal_scoped_warm and plan_key is None and not same.all():
                    warm = False
                else:
                    flow0 = np.where(
                        same, np.minimum(self._prev, cap), 0
                    ).astype(np.int32)
        had_state = self._prev is not None or self._prev_dev is not None
        self.last_warm_scope = (
            "warm" if warm else ("fresh" if had_state else "cold")
        )
        warm_p_ok = (
            self.warm_potentials
            and warm
            and self._prev_p is not None
            and self._prev_p.shape[0] == n_cap
        )
        budget = min(4096, self.batcher.max_supersteps)
        if warm and self.restart_budget is not None:
            budget = min(budget, self.restart_budget)
        group_key = (
            n_cap, m_cap, warm_p_ok, budget, tel_cap,
            self.tenant if self.quarantined else None,
        )
        req = self.batcher.park(
            _LaneRequest(
                solver=self,
                group_key=group_key,
                dev_args=dev_args,
                flow0=flow0,
                eps=np.int32(1),
                warm_p=self._prev_p if warm_p_ok else None,
                plan_args=plan_args,
                budget=budget,
                tel_cap=tel_cap,
                use_warm_p=warm_p_ok,
            )
        )
        cold = (np.zeros(m_cap, dtype=np.int32), max(1, max_cost * n_cap))
        return (orig, req, (problem, cold, warm, resident))

    def _lane_attempt(self, req, flow0, eps, budget):
        """A per-lane escalation attempt (fresh restart / cost-scaling)
        through the ordinary single-lane program — exactly the attempts
        CsrSolver.complete runs, so an escaped lane's result is still
        bit-identical to the lane solved alone."""
        return _solve_mcmf(
            *(torch.as_tensor(a, device=self.device) for a in req.dev_args),
            torch.as_tensor(flow0, device=self.device),
            int(eps),
            *req.plan_args,
            alpha=self.batcher.alpha,
            max_supersteps=budget,
            tighten_sweeps=self.batcher.tighten_sweeps,
            telemetry_cap=req.tel_cap,
        )

    def complete(self, pending) -> FlowResult:
        from ..obs import soltel

        orig, req, rest = pending
        if req is None:
            self.last_telemetry = None
            self.last_warm_escape = False
            return FlowResult(
                flow=np.zeros(len(orig.src), dtype=np.int64),  # kschedlint: host-only (FlowResult contract is int64)
                objective=0, iterations=0,
            )
        problem, (f0_cold, eps_cold), warm, resident = rest
        with soltel.stall_scope(self.tenant or None):
            return self._complete_scoped(
                orig, req, problem, f0_cold, eps_cold, warm, resident
            )

    def _complete_scoped(self, orig, req, problem, f0_cold, eps_cold, warm, resident):
        from ..obs import soltel

        self.batcher.ensure(req)
        tel_cap = req.tel_cap
        tel_buf = None
        if tel_cap:
            flow, p, steps, converged, p_overflow, tel_buf = req.outputs
        else:
            flow, p, steps, converged, p_overflow = req.outputs
        spent = int(steps)
        self.last_warm_escape = False
        warm_failed = warm and not (bool(converged) and not bool(p_overflow))
        if warm_failed and not bool(converged):
            self.last_warm_escape = True
            self.warm_escapes_total += 1
            soltel.warm_price_war(
                "lane",
                supersteps=int(steps),
                budget=req.budget,
                escaped_to=(
                    "fresh_restart" if self.restart_budget is not None
                    else "cost_scaling"
                ),
                tel=(
                    soltel.decode(
                        tel_buf, int(steps), tel_cap, "lane", req.budget,
                        converged=False,
                        nodes=problem.num_nodes, arcs=len(problem.src),
                    )
                    if tel_buf is not None
                    else None
                ),
            )
        if warm_failed and self.restart_budget is not None:
            out = self._lane_attempt(
                req, f0_cold, 1, min(4096, self.batcher.max_supersteps)
            )
            if tel_cap:
                flow, p, steps, converged, p_overflow, tel_buf = out
            else:
                flow, p, steps, converged, p_overflow = out
            spent += int(steps)
        if not (bool(converged) and not bool(p_overflow)):
            out = self._lane_attempt(
                req, f0_cold, eps_cold, self.batcher.max_supersteps
            )
            if tel_cap:
                flow, p, steps, converged, p_overflow, tel_buf = out
            else:
                flow, p, steps, converged, p_overflow = out
            spent += int(steps)
        self.last_supersteps = spent
        self.last_telemetry = (
            soltel.decode(
                tel_buf, int(steps), tel_cap, "lane",
                self.batcher.max_supersteps,
                converged=bool(converged) and not bool(p_overflow),
                nodes=problem.num_nodes, arcs=len(problem.src),
            )
            if tel_buf is not None
            else None
        )
        if bool(p_overflow) or not bool(converged):
            self.reset()
        if bool(p_overflow):
            raise OverflowError("push-relabel potentials approached int32 range")
        if not bool(converged):
            tel = self.last_telemetry
            raise soltel.SolverStallError(
                f"lane did not converge within {self.batcher.max_supersteps} "
                "supersteps; the flow problem may be infeasible",
                reason=soltel.detect_stall(tel) if tel is not None else None,
                telemetry=tel,
            )
        flow_np = flow.cpu().numpy()
        if self.warm_start:
            self._prev = flow_np.astype(np.int32)
            self._prev_dev = flow if resident else None
            self._prev_src_dev = problem.d_src if resident else None
            self._prev_dst_dev = problem.d_dst if resident else None
            self._prev_src_host = np.asarray(problem.src, np.int32)
            self._prev_dst_host = np.asarray(problem.dst, np.int32)
            self._key_solved = getattr(problem, "plan_key", None)
            self._prev_p = p
        # the FlowResult is for the CALLER's (unpadded) problem: lane
        # padding arcs are zero-capacity and carry zero flow, so the
        # real prefix is the whole answer
        m0 = len(orig.src)
        flow_out = flow_np[:m0]
        objective = int(
            (flow_out.astype(np.int64) * orig.cost.astype(np.int64)).sum()  # kschedlint: disable=dtype64,int32-reduce -- int64 objective on the host
        ) + lower_bound_cost(orig)
        return FlowResult(flow=flow_out.astype(np.int64), objective=objective, iterations=spent)  # kschedlint: host-only (FlowResult contract is int64)

    def solve(self, problem: FlowProblem) -> FlowResult:
        return self.complete(self.solve_async(problem))



from ..analysis.program_registry import declare_programs as _declare_programs  # noqa: E402

_declare_programs(__name__, "stacked_solve")
