"""Tenant lifecycle policy: admission control, fairness, quarantine.

The policy layer is deliberately separate from the mechanics (batch.py
solves lanes, service.py drives cells) so it is unit-testable without a
solver in sight:

- **admission control** bounds what one warm process accepts: a tenant
  count cap, per-tenant graph-size caps (the pow2 bucket a tenant may
  occupy is priced in nodes/arcs), and a per-bucket lane cap so one
  popular shape bucket cannot crowd out the rest of the process.
- **fairness** is a rotation: the processing order of cells advances
  by one each round, so no tenant systematically polls/dispatches/
  completes last. (Within the stacked solve fairness is structural:
  per-lane budgets bound every lane's supersteps, and escalations run
  per-lane.)
- **quarantine** handles the pathological tenant: a lane whose warm
  attempts keep blowing their restart budget (or whose rounds keep
  ending NOOP) is moved into its OWN stacked group for a penalty
  window — it still solves, with its own budgets, but it can no longer
  stretch the shared program's while-loop. Chaos-injected faults never
  reach the batch at all (they raise at dispatch, before the lane
  parks), so quarantine is about *convergence* pathology, not faults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..obs.metrics import get_registry


class AdmissionError(RuntimeError):
    """The process refused a tenant (capacity or size caps)."""


@dataclass
class AdmissionPolicy:
    #: hard cap on admitted tenants per process
    max_tenants: int = 64
    #: per-tenant graph-size caps (pow2 bucket extents)
    max_nodes: int = 1 << 20
    max_arcs: int = 1 << 22
    #: lanes one shape bucket may hold (a stacked program's width)
    max_lanes_per_bucket: int = 64
    #: consecutive bad rounds (warm-budget escapes or NOOPs) before a
    #: lane is quarantined into its own stacked group
    quarantine_after: int = 3
    #: rounds a quarantined lane stays solo before re-probation
    quarantine_rounds: int = 16


@dataclass
class TenantAccount:
    """Per-tenant policy state the manager maintains."""

    tenant_id: str
    bucket: Tuple[int, int]  # (n_cap, m_cap) admitted bucket
    rounds: int = 0
    noop_rounds: int = 0
    warm_escapes: int = 0
    bad_streak: int = 0
    quarantined_until: int = -1
    quarantine_count: int = 0
    extra: Dict[str, object] = field(default_factory=dict)

    @property
    def quarantined(self) -> bool:
        return self.quarantined_until > self.rounds


class TenantManager:
    """Admission + fairness + quarantine bookkeeping for one process.

    The service registers each admitted tenant's `LaneSolver` so the
    manager can flip its ``quarantined`` flag; everything else here is
    plain accounting."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None) -> None:
        self.policy = policy or AdmissionPolicy()
        self.accounts: Dict[str, TenantAccount] = {}
        self._lanes: Dict[str, object] = {}  # tenant_id -> LaneSolver
        reg = get_registry()
        self._m_admitted = reg.gauge(
            "ksched_tenants", "tenants currently admitted"
        )
        self._m_rejected = reg.counter(
            "ksched_tenant_admission_rejected_total",
            "admission refusals, by why",
            labelnames=("reason",),
        )
        self._m_quarantined = reg.counter(
            "ksched_tenant_quarantines_total",
            "lanes moved into solo stacked groups",
        )

    # -- admission ---------------------------------------------------------

    def admit(
        self,
        tenant_id: str,
        est_nodes: int,
        est_arcs: int,
    ) -> TenantAccount:
        """Admit a tenant or raise AdmissionError. ``est_nodes``/
        ``est_arcs`` are the tenant's expected pow2 bucket extents (the
        bucket is priced at admission; a tenant that later outgrows its
        admitted caps shows up in ``oversized_tenants``)."""
        from ..utils import next_pow2

        if tenant_id in self.accounts:
            raise AdmissionError(f"tenant {tenant_id!r} already admitted")
        if len(self.accounts) >= self.policy.max_tenants:
            self._m_rejected.labels(reason="max_tenants").inc()
            raise AdmissionError(
                f"process at max_tenants={self.policy.max_tenants}"
            )
        if est_nodes > self.policy.max_nodes or est_arcs > self.policy.max_arcs:
            self._m_rejected.labels(reason="size_cap").inc()
            raise AdmissionError(
                f"tenant {tenant_id!r} bucket ({est_nodes} nodes, {est_arcs} "
                f"arcs) exceeds the per-tenant caps "
                f"({self.policy.max_nodes}, {self.policy.max_arcs})"
            )
        bucket = (max(next_pow2(est_nodes), 16), max(next_pow2(est_arcs), 16))
        peers = sum(1 for a in self.accounts.values() if a.bucket == bucket)
        if peers >= self.policy.max_lanes_per_bucket:
            self._m_rejected.labels(reason="bucket_full").inc()
            raise AdmissionError(
                f"bucket {bucket} already holds "
                f"{self.policy.max_lanes_per_bucket} lanes"
            )
        account = TenantAccount(tenant_id=tenant_id, bucket=bucket)
        self.accounts[tenant_id] = account
        self._m_admitted.set(len(self.accounts))
        return account

    def register_lane(self, tenant_id: str, lane) -> None:
        """Attach the admitted tenant's LaneSolver so quarantine
        decisions can flip its grouping (the lane usually does not
        exist yet at admit time — the service builds it after the
        admission check passes)."""
        if tenant_id not in self.accounts:
            raise AdmissionError(f"tenant {tenant_id!r} is not admitted")
        self._lanes[tenant_id] = lane

    def evict(self, tenant_id: str) -> None:
        self.accounts.pop(tenant_id, None)
        self._lanes.pop(tenant_id, None)
        self._m_admitted.set(len(self.accounts))

    # -- fairness ----------------------------------------------------------

    def order(self, round_index: int) -> List[str]:
        """Cell processing order for a round: admission order rotated
        by the round index, so every tenant periodically goes first
        (and last) in the poll/dispatch/complete phases."""
        ids = list(self.accounts)
        if not ids:
            return ids
        k = round_index % len(ids)
        return ids[k:] + ids[:k]

    # -- quarantine --------------------------------------------------------

    def note_round(
        self, tenant_id: str, noop: bool = False, warm_escape: bool = False
    ) -> None:
        """Attribute one finished round to a tenant and update its
        quarantine state. Called by the service after each cell's
        complete phase."""
        a = self.accounts.get(tenant_id)
        if a is None:
            return
        was_quarantined = a.quarantined
        a.rounds += 1
        if noop:
            a.noop_rounds += 1
        if warm_escape:
            a.warm_escapes += 1
        if noop or warm_escape:
            a.bad_streak += 1
        else:
            a.bad_streak = 0
        if (
            not was_quarantined
            and a.bad_streak >= self.policy.quarantine_after
        ):
            a.quarantined_until = a.rounds + self.policy.quarantine_rounds
            a.quarantine_count += 1
            a.bad_streak = 0
            self._m_quarantined.inc()
        lane = self._lanes.get(tenant_id)
        if lane is not None:
            lane.quarantined = a.quarantined

    def oversized_tenants(self) -> List[str]:
        """Tenants whose lanes now exceed their admitted bucket (the
        operator's resize-or-evict signal)."""
        out = []
        for tid, a in self.accounts.items():
            lane = self._lanes.get(tid)
            prev = getattr(lane, "_prev_src_host", None) if lane is not None else None
            if prev is not None and len(prev) > a.bucket[1]:
                out.append(tid)
        return out
