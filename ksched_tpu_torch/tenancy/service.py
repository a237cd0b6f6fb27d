"""MultiTenantService: N independent cells, one warm solver process.

Each admitted tenant is a full `SchedulerService` cell — its own
ClusterAPI adapter, resource topology, pod/task maps, degradation
ladder, deadline watchdog, heartbeat monitor, flight recorder, and
(when chaos is configured) its own fault injector — multiplexed through
a four-phase round:

1. **dispatch** (per cell, fairness-rotated order): poll the tenant's
   control plane, ingest pods, journal the graph delta, and dispatch
   the solve — the tenant's `LaneSolver` parks a lane with the shared
   `StackedBatcher` instead of running its own program;
2. **flush**: the batcher groups same-bucket/same-policy lanes and
   runs ONE stacked solve per group;
3. **post window** (per cell): the PREVIOUS round's binding POSTs, in
   the batched solve's window — the `--pipeline` dispatch window,
   generalized per tenant (the port's flush has finished the card's
   work by then, where the JAX package's dispatches asynchronously);
4. **complete** (per cell): synchronize the lane, apply deltas, queue
   this round's bindings, heartbeat sweep, and trace attribution —
   including the NOOP backstop when the tenant's whole ladder failed.

Isolation properties (asserted by the tenancy tests and the tenant
soak, drivers/soak.py `run_tenant_soak`):

- a lane's solve is bit-identical to the same tenant running alone
  (per-lane masks in the stacked solve + per-tenant warm state +
  per-tenant RNG streams);
- chaos on one tenant degrades only its own lane: injected faults
  raise at that cell's dispatch/complete (never entering the shared
  batch), its ladder degrades to its own jax/cpu_ref rungs, and at
  worst ITS round goes NOOP while every other cell's record stays
  fault-free;
- accounting is per-tenant end to end: every cell's metric handles
  resolve against a ``tenant``-labelled scoped view of one shared
  registry, round records carry ``tenant``, flight dumps are
  tenant-scoped files, and soltel stall events are tagged with the
  tenant whose lane produced them.

Port of ksched_tpu/tenancy/service.py. The cells' solves run on
``device`` ("cuda" by default; it raises where there is no card).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

from ..cli import SchedulerService
from ..cluster import ClusterAPI, SyntheticClusterAPI
from ..costmodels import CostModelType
from ..obs import metrics as obs_metrics
from ..obs import soltel
from ..obs.flight import FlightRecorder
from ..obs.spans import span
from ..runtime.trace import RoundTracer
from ..utils.device import resolve_device
from ..utils.ids import rng as global_rng
from ..utils.ids import seed_rng
from .batch import LaneSolver, StackedBatcher
from .manager import AdmissionPolicy, TenantManager


class TenantCell:
    """One tenant's slice of the process: the cell's SchedulerService
    plus the per-round glue (RNG stream swapping, injector clock, span
    marks, quarantine attribution)."""

    def __init__(
        self,
        service: "MultiTenantService",
        tenant_id: str,
        api: ClusterAPI,
        svc: SchedulerService,
        lane: LaneSolver,
        injector=None,
        poll_timeout_s: float = 0.005,
    ) -> None:
        self.service = service
        self.tenant_id = tenant_id
        self.api = api
        self.svc = svc
        self.lane = lane
        self.injector = injector
        self.poll_timeout_s = poll_timeout_s
        self.tick = 0
        self._begin_events = None
        self._noop_mark = 0
        self._rng_state = None  # installed by add_tenant after build

    # -- per-tenant RNG stream ---------------------------------------------
    # Task/job/machine ids come from the process-global seeded RNG
    # (utils/ids.py). Interleaved cells must each consume their OWN
    # continuation of their seed's stream, or ids — and therefore
    # placements — would differ between a multi-tenant run and the same
    # tenant run in isolation (the bit-parity acceptance). Same pattern
    # as bench.py's interleaved arms: park/swap the stream around every
    # cell phase that can create ids.

    def _swap_in(self):
        outer = global_rng().getstate()
        global_rng().setstate(self._rng_state)
        return outer

    def _park(self, outer) -> None:
        self._rng_state = global_rng().getstate()
        global_rng().setstate(outer)

    # -- round phases ------------------------------------------------------

    def begin(self, now: Optional[float] = None) -> int:
        """Phase 1: injector clock, poll, ingest, dispatch."""
        outer = self._swap_in()
        try:
            if self.injector is not None:
                self.injector.begin_round(self.tick)
            self.tick += 1
            pods = self.api.poll_pod_batch(self.poll_timeout_s)
            tracer = self.service.span_tracer
            mark = tracer.mark() if tracer is not None else 0
            self._noop_mark = self.svc.noop_rounds
            # the quarantine signal must be THIS round's: a round whose
            # rung-0 dispatch fails (chaos) never reaches the lane's
            # complete(), and a stale True from a previous round would
            # count as a fresh escape in the manager's streak
            self.lane.last_warm_escape = False
            with soltel.stall_scope(self.tenant_id), span(
                "tenant_dispatch", tenant=self.tenant_id, pods=len(pods)
            ):
                self.svc.dispatch_round(pods)
            # snapshot this cell's OWN dispatch-phase spans now: the
            # wall-clock window until finish() contains every other
            # cell's phases, which must not leak into a tenant-scoped
            # flight dump (finish passes this slice as the prefix)
            self._begin_events = (
                list(tracer.events_since(mark)) if tracer is not None else None
            )
            return len(pods)
        finally:
            self._park(outer)

    def post_window(self) -> int:
        """Phase 3: the previous round's binding POSTs, inside the
        batched-solve window (pipeline mode; a no-op otherwise)."""
        if not self.svc._pending_bindings:
            return 0
        with span("tenant_post_window", tenant=self.tenant_id):
            return self.svc.flush_pending_bindings()

    def finish(self, now: Optional[float] = None) -> int:
        """Phase 4: synchronize the lane, apply, sweep, trace; then
        feed the manager's quarantine accounting."""
        outer = self._swap_in()
        try:
            tracer = self.service.span_tracer
            mark = tracer.mark() if tracer is not None else 0
            with soltel.stall_scope(self.tenant_id), span(
                "tenant_finish", tenant=self.tenant_id
            ):
                bound = self.svc.complete_round(
                    now=now, span_mark=mark, span_prefix=self._begin_events
                )
        finally:
            self._park(outer)
        self.service.manager.note_round(
            self.tenant_id,
            noop=self.svc.noop_rounds > self._noop_mark,
            warm_escape=self.lane.last_warm_escape,
        )
        return bound

    def drain(self) -> None:
        """Post anything still queued (service shutdown / eviction)."""
        self.svc.flush_pending_bindings()


class MultiTenantService:
    """The scheduler-as-a-service process: admit cells, run rounds.

    ``registry`` is the SHARED parent registry; each cell's handles
    resolve against ``registry.scoped(tenant=<id>)``, so one /metricsz
    surface serves every tenant with a ``tenant`` label. ``pipeline``
    turns on the per-tenant dispatch windows (phase 3); without it each
    cell posts its bindings synchronously in phase 4. Every cell's lane,
    ladder and device-resident mirror live on ``device``."""

    def __init__(
        self,
        registry=None,
        policy: Optional[AdmissionPolicy] = None,
        round_deadline_s: float = 30.0,
        pipeline: bool = True,
        device_resident: bool = False,
        flight_dir: Optional[str] = None,
        flight_capacity: int = 32,
        span_tracer=None,
        alpha: int = 8,
        max_supersteps: int = 50_000,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.registry = (
            registry if registry is not None else obs_metrics.get_registry()
        )
        # batcher/manager handles resolve against the PARENT registry
        # (process-level families; per-tenant families ride the scoped
        # views built in add_tenant)
        with obs_metrics.scoped_registry(self.registry):
            self.batcher = StackedBatcher(
                alpha=alpha, max_supersteps=max_supersteps, device=self.device
            )
            self.manager = TenantManager(policy)
        self.round_deadline_s = round_deadline_s
        self.pipeline = pipeline
        self.device_resident = device_resident
        self.flight_dir = flight_dir
        self.flight_capacity = flight_capacity
        self.span_tracer = span_tracer
        self.cells: Dict[str, TenantCell] = {}
        self.round_index = 0

    def _scoped(self, tenant_id: str):
        """The tenant's labelled registry view (the parent itself when
        it cannot scope — the null registry)."""
        scoped = getattr(self.registry, "scoped", None)
        return scoped(tenant=tenant_id) if scoped is not None else self.registry

    # -- tenant lifecycle --------------------------------------------------

    def add_tenant(
        self,
        tenant_id: str,
        api: Optional[ClusterAPI] = None,
        machines: int = 4,
        pus_per_core: int = 2,
        slots: int = 16,
        cost_model: CostModelType = CostModelType.TRIVIAL,
        injector=None,
        seed: int = 0,
        restart_budget: Optional[int] = 64,
        bucket_floor: Optional[Tuple[int, int]] = None,
        machine_timeout_s: float = 0.0,
        est_nodes: Optional[int] = None,
        est_arcs: Optional[int] = None,
        poll_timeout_s: float = 0.005,
        audit_every: int = 0,
    ) -> TenantCell:
        """Admit one cell: admission control first, then the cell's
        SchedulerService is built under the tenant's scoped registry
        and its own seeded RNG stream (so the cell is reproducible in
        isolation). ``api`` defaults to an in-process synthetic control
        plane; pass an `HTTPClusterAPI` to multiplex real control
        planes through one process."""
        pus = machines * pus_per_core
        if est_nodes is None:
            # rough pow2-bucket estimate: topology nodes + a working
            # set of tasks/ECs; the DeviceGraphState bucket is what
            # actually gets priced, this just gates admission
            est_nodes = 2 * (machines * (2 + pus_per_core) + pus * slots + 16)
        if est_arcs is None:
            est_arcs = 4 * est_nodes
        account = self.manager.admit(tenant_id, est_nodes, est_arcs)
        scoped = self._scoped(tenant_id)
        if api is None:
            api = SyntheticClusterAPI()
        outer = global_rng().getstate()
        seed_rng(seed)
        try:
            with obs_metrics.scoped_registry(scoped):
                lane = LaneSolver(
                    self.batcher,
                    tenant=tenant_id,
                    restart_budget=restart_budget,
                    bucket_floor=bucket_floor,
                    device=self.device,
                )
                flight = None
                if self.flight_dir:
                    flight = FlightRecorder(
                        capacity=self.flight_capacity,
                        dump_dir=self.flight_dir,
                        registry=scoped,
                        scope=tenant_id,
                        min_rounds_between_dumps=8,
                    )
                svc = SchedulerService(
                    api,
                    max_tasks_per_pu=slots,
                    cost_model=cost_model,
                    backend=lane,
                    backend_name="lane",
                    degrade=True,
                    injector=injector,
                    tracer=RoundTracer(registry=scoped),
                    round_deadline_s=self.round_deadline_s,
                    flight=flight,
                    span_tracer=self.span_tracer,
                    pipeline=self.pipeline,
                    device_resident=self.device_resident,
                    tenant=tenant_id,
                    audit_every=audit_every,
                    device=self.device,
                )
                if machine_timeout_s > 0:
                    svc.enable_heartbeats(machine_timeout_s=machine_timeout_s)
                svc.init_topology(
                    fake_machines=machines, pus_per_core=pus_per_core
                )
            cell = TenantCell(
                self, tenant_id, api, svc, lane,
                injector=injector, poll_timeout_s=poll_timeout_s,
            )
            cell._rng_state = global_rng().getstate()
        except BaseException:
            self.manager.evict(tenant_id)
            raise
        finally:
            global_rng().setstate(outer)
        self.manager.register_lane(tenant_id, lane)
        account.extra["seed"] = seed
        self.cells[tenant_id] = cell
        return cell

    def save_tenant_checkpoint(self, tenant_id: str, path: str) -> None:
        """Checkpoint ONE cell (sidecar + .sched + warm .wal manifest,
        via its SchedulerService) under that tenant's scoped registry
        and parked RNG stream — the per-tenant slice of the state
        manifest: its own slot-plan geometry, warm endpoints, and
        ladder counters, with the cell's quarantine streak riding the
        sidecar-adjacent meta returned to the manager's account."""
        cell = self.cells[tenant_id]
        outer = global_rng().getstate()
        global_rng().setstate(cell._rng_state)
        try:
            with obs_metrics.scoped_registry(self._scoped(tenant_id)):
                cell.svc.save_checkpoint(path)
            cell._rng_state = global_rng().getstate()
        finally:
            global_rng().setstate(outer)
        account = self.manager.accounts.get(tenant_id)
        if account is not None:
            account.extra["checkpoint"] = path
            account.extra["quarantine_streak"] = account.bad_streak

    def remove_tenant(self, tenant_id: str) -> None:
        cell = self.cells.pop(tenant_id, None)
        if cell is not None:
            cell.drain()
        self.manager.evict(tenant_id)

    # -- the multiplexed round ---------------------------------------------

    def run_round(self, now: Optional[float] = None) -> Dict[str, int]:
        """One multiplexed round across every cell; returns bindings
        queued/posted per tenant.

        Per-cell fault barrier: one tenant's failure must not wedge the
        fleet. A cell whose begin/finish raises is skipped for the rest
        of the round (its own split-round latch always clears — a
        failed dispatch never sets it, and complete_round clears it on
        entry), every OTHER dispatched cell still completes, and the
        first error re-raises only after the round is consistent. A
        POST failure in a cell's dispatch window is warned and retried
        at that cell's next flush point (the batch restores itself),
        exactly the single-tenant retry semantics — it never blocks
        other tenants' phases."""
        order = [
            self.cells[tid]
            for tid in self.manager.order(self.round_index)
            if tid in self.cells
        ]
        errors: list = []
        dispatched: list = []
        # BaseException on purpose at every barrier: a KeyboardInterrupt
        # landing in one cell's phase must still let every OTHER
        # dispatched cell synchronize (the same in-flight-latch
        # invariant _run_once_pipelined documents) — it re-raises AS
        # ITSELF after the round is consistent, never wrapped
        for cell in order:
            try:
                cell.begin(now)
            except BaseException as e:  # noqa: BLE001 — re-raised after the round
                errors.append((cell.tenant_id, e))
            else:
                dispatched.append(cell)
        with span(
            "batch_flush",
            lanes=len(self.batcher._parked),
        ):
            # flush contains its own per-GROUP fault barrier (a failed
            # group's lanes re-raise at complete and degrade their own
            # ladders); it does not raise for solver-shaped failures
            self.batcher.flush()
        for cell in dispatched:
            try:
                cell.post_window()
            except Exception as e:  # noqa: BLE001 — batch restored for retry
                warnings.warn(
                    f"tenant {cell.tenant_id!r}: binding POST failed in the "
                    f"dispatch window ({e}); batch queued for retry at the "
                    "next flush point",
                    RuntimeWarning,
                    stacklevel=2,
                )
            except BaseException as e:  # noqa: BLE001 — KI: finish cells first
                errors.append((cell.tenant_id, e))
        bound: Dict[str, int] = {}
        for cell in dispatched:
            try:
                bound[cell.tenant_id] = cell.finish(now)
            except BaseException as e:  # noqa: BLE001 — re-raised after the round
                errors.append((cell.tenant_id, e))
        self.round_index += 1
        if errors:
            for _tid, err in errors:
                if not isinstance(err, Exception):
                    raise err  # KeyboardInterrupt/SystemExit as themselves
            tid, err = errors[0]
            raise RuntimeError(
                f"tenant {tid!r} failed its round (fleet state is "
                f"consistent; {len(errors)} cell(s) affected)"
            ) from err
        return bound

    def run(self, rounds: int, now_fn=None) -> None:
        """Drive ``rounds`` multiplexed rounds (logical time via
        ``now_fn(round_index)`` when given), then drain every cell's
        queued POSTs."""
        for r in range(rounds):
            self.run_round(now=now_fn(r) if now_fn is not None else None)
        self.drain()

    def drain(self) -> None:
        for cell in self.cells.values():
            cell.drain()

    def close(self) -> None:
        self.drain()
        for cell in self.cells.values():
            cell.api.close()

    # -- reporting ---------------------------------------------------------

    def tenant_summary(self, phase: str = "total") -> Dict[str, dict]:
        """Per-tenant round-latency percentiles (RoundTracer.summary
        per cell) — the per-tenant p50/p99 surface the soak and bench
        publish."""
        return {
            tid: cell.svc.tracer.summary(phase)
            for tid, cell in self.cells.items()
            if cell.svc.tracer is not None
        }
