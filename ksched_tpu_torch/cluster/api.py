"""The cluster API protocol: pods/nodes in, bindings out.

Reference shape: k8s/k8sclient/client.go —
- two informers feed buffered channels (pods :49-78, nodes :82-105);
- `GetPodBatch` debounce-batches pod arrivals (:153-193);
- `AssignBinding` posts pod→node bindings back (:128-147);
- internal types Pod{ID}, Node{ID}, Binding{PodID, NodeID}
  (k8s/k8stype/types.go:3-13).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class PodEvent:
    """An unscheduled pod surfaced by the control plane."""

    pod_id: str
    # Optional scheduling inputs (the reference's Pod carries only the
    # id; the rebuild forwards resource requests when the source has them)
    cpu_request: float = 0.0
    net_bw_request: int = 0
    task_class: int = 0


@dataclass(frozen=True)
class NodeEvent:
    """A schedulable node surfaced by the control plane."""

    node_id: str
    num_cores: int = 1
    pus_per_core: int = 1
    net_bw_capacity: int = 0


@dataclass(frozen=True)
class Binding:
    pod_id: str
    node_id: str


class ClusterAPI(abc.ABC):
    """What the scheduler main loop needs from a control plane."""

    @abc.abstractmethod
    def get_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        """Debounced batch: block until the first pod arrives, then keep
        draining, restarting the quiet-period timer on every arrival,
        until ``timeout_s`` elapses with no new pod (reference:
        client.go:153-193). Returns [] only on close/shutdown."""

    def poll_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        """Bounded variant of get_pod_batch: the *first* wait is capped
        at ``timeout_s`` too, so an empty return can mean "no pods right
        now" — not only "closed". The hardened service loop uses this
        plus ``is_closed()`` to tell a transient API-server outage from
        shutdown (an outage must idle the scheduler, never exit it) and
        to keep heartbeat sweeps running while the queue is quiet.

        Default: delegate to the blocking contract, under which an
        empty batch *does* mean closed — recorded so the default
        ``is_closed()`` agrees and the service loop still exits cleanly
        for adapters that override neither method (overriding only one
        of the pair would otherwise leave the loop spinning on instant
        empty batches forever after close)."""
        batch = self.get_pod_batch(timeout_s)
        if not batch:
            self._default_poll_closed = True
        return batch

    def is_closed(self) -> bool:
        """True once close() has been called (or the transport knows the
        control plane is gone for good). The loop-exit signal: an empty
        batch alone is NOT one. Adapters with a real channel override
        this; the default pairs with the default poll_pod_batch above."""
        return getattr(self, "_default_poll_closed", False)

    @abc.abstractmethod
    def get_node_batch(self, timeout_s: float) -> List[NodeEvent]:
        """Same debounce contract for node arrivals (the reference polls
        its node channel for a fixed window at startup,
        cmd/k8sscheduler/scheduler.go:206-238)."""

    @abc.abstractmethod
    def assign_bindings(self, bindings: List[Binding]) -> None:
        """Push pod→node placements to the control plane."""

    def close(self) -> None:
        """Stop delivering events; get_*_batch return [] afterwards."""


#: The ``stats()`` keys that count retry/re-post attempts — the only
#: keys the round trace folds into ``RoundRecord.retries``. Drop
#: counters (binding_drops) are a separate signal and must stay out.
#: An adapter defining a new retry counter must list it here to be
#: attributed; an explicit list fails visibly where a substring match
#: would drift silently.
RETRY_STAT_KEYS = ("binding_retries", "watch_retries", "binding_reposts_pending")
