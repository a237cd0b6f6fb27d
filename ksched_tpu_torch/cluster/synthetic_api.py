"""In-process synthetic control plane.

Plays the role the real API server plays for the reference's informers
(k8s/k8sclient/client.go:49-105) and the role `podgen` plays for load
(cmd/podgen/podgen.go): producers submit pods/nodes from any thread;
the scheduler loop drains them with the same debounced-batch semantics
as GetPodBatch (client.go:153-193); bindings are recorded and can be
asserted on by tests or scraped by drivers.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

from .api import Binding, ClusterAPI, NodeEvent, PodEvent


class SyntheticClusterAPI(ClusterAPI):
    def __init__(self, pod_chan_size: int = 5000) -> None:
        # Buffered like the reference's pod channel (-pcs flag,
        # cmd/k8sscheduler/scheduler.go:36).
        self._pods: "queue.Queue[PodEvent]" = queue.Queue(maxsize=pod_chan_size)
        self._nodes: "queue.Queue[NodeEvent]" = queue.Queue()
        self._bindings: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()

    # -- producer side (what podgen / node lifecycle drives) --------------

    def submit_pod(self, pod: PodEvent) -> None:
        self._pods.put(pod)

    def offer_pod(self, pod: PodEvent, timeout_s: float) -> bool:
        """Bounded-wait submit for producers that must stay responsive
        to shutdown (the HTTP watch threads): returns False instead of
        blocking past timeout_s when the channel is full."""
        try:
            self._pods.put(pod, timeout=timeout_s)
            return True
        except queue.Full:
            return False

    def submit_node(self, node: NodeEvent) -> None:
        self._nodes.put(node)

    def close(self) -> None:
        self._closed.set()

    def is_closed(self) -> bool:
        return self._closed.is_set()

    # -- consumer side (the scheduler main loop) --------------------------

    def _batch(self, q: "queue.Queue", timeout_s: float, wait_first: bool) -> list:
        """Debounce: wait for the first event, then drain with the quiet
        timer reset per arrival (reference: client.go:153-193).
        wait_first=True blocks indefinitely for the first event (the pod
        contract); False bounds the initial wait by timeout_s (the node
        startup-window contract, cmd/k8sscheduler/scheduler.go:206-238)."""
        batch = []
        first_deadline = None if wait_first else time.monotonic() + timeout_s
        # Phase 1 (poll so close() can land).
        while not self._closed.is_set():
            wait = 0.05
            if first_deadline is not None:
                remaining = first_deadline - time.monotonic()
                if remaining <= 0:
                    return batch
                wait = min(wait, remaining)
            try:
                batch.append(q.get(timeout=wait))
                break
            except queue.Empty:
                continue
        if not batch:
            return batch
        # Phase 2: keep draining until quiet for timeout_s.
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(q.get(timeout=remaining))
                deadline = time.monotonic() + timeout_s  # timer reset
            except queue.Empty:
                break
        return batch

    def get_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        return self._batch(self._pods, timeout_s, wait_first=True)

    def poll_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        """Bounded-first-wait batch (see ClusterAPI.poll_pod_batch):
        empty means "quiet", not "closed" — check is_closed()."""
        return self._batch(self._pods, timeout_s, wait_first=False)

    def get_node_batch(self, timeout_s: float) -> List[NodeEvent]:
        return self._batch(self._nodes, timeout_s, wait_first=False)

    def assign_bindings(self, bindings: List[Binding]) -> None:
        with self._lock:
            for b in bindings:
                self._bindings[b.pod_id] = b.node_id

    # -- inspection -------------------------------------------------------

    def bindings(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._bindings)
