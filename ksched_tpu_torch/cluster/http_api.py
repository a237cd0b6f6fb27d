"""HTTP transport for the cluster API: the real-control-plane adapter.

Reference shape: the k8s client (k8s/k8sclient/client.go) runs informers
against the API server (HTTP watches feeding channels, :49-105) and
POSTs Binding subresources back (:128-147). This adapter is that
pattern over the rebuild's ClusterAPI protocol:

- two watch threads poll the pending-pods and nodes listings (the
  informer analogue; field-selector semantics — only pods with no node
  assignment — live server-side, exactly as the reference's selector
  `spec.nodeName==""` does, client.go:53-60) and feed the same buffered
  channels + debounce machinery the synthetic control plane uses;
- `assign_bindings` POSTs one k8s-shaped Binding subresource per
  placement: POST /api/v1/namespaces/{ns}/pods/{pod}/binding with a
  {"target": {"kind": "Node", "name": node}} body (client.go:128-147).

stdlib urllib only — no client dependencies. Pairs with
cluster/fake_apiserver.py for hermetic tests and demos. Auth plumbing
for a real kube-apiserver (the reference builds an authenticated
client, k8s/k8sclient/client.go:34-42): `bearer_token` rides every
request as an Authorization header, `ca_cert` pins the server cert for
https URLs, and `client_cert`/`client_key` enable mTLS — exercised
hermetically against the fake server's TLS mode.
"""

from __future__ import annotations

import json
import random
import ssl
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set

from ..obs.metrics import Registry
from ..utils.backoff import ExpBackoff
from .api import Binding, ClusterAPI, NodeEvent, PodEvent
from .synthetic_api import SyntheticClusterAPI


class HTTPClusterAPI(ClusterAPI):
    def __init__(
        self,
        base_url: str,
        namespace: str = "default",
        poll_interval_s: float = 0.2,
        pod_chan_size: int = 5000,
        bearer_token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        client_cert: Optional[str] = None,
        client_key: Optional[str] = None,
        request_timeout_s: float = 5.0,
        retry_budget: int = 4,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        backoff_rng: Optional[random.Random] = None,
        registry: Optional[Registry] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace
        self.poll_interval_s = poll_interval_s
        self._auth_headers = (
            {"Authorization": f"Bearer {bearer_token}"} if bearer_token else {}
        )
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            self._ssl_ctx = ssl.create_default_context(cafile=ca_cert)
            if client_cert:
                self._ssl_ctx.load_cert_chain(client_cert, client_key)
        elif ca_cert or client_cert or client_key:
            # cert material with a plain-http URL is always a config
            # mistake (a forgotten scheme would silently drop the mTLS
            # identity and send the bearer token in cleartext)
            raise ValueError(
                "ca_cert/client_cert/client_key require an https base_url"
            )
        self.request_timeout_s = request_timeout_s
        self.retry_budget = retry_budget
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._backoff_rng = backoff_rng if backoff_rng is not None else random.Random()
        # The watch loops' failure-streak backoff shares the ExpBackoff
        # growth/jitter policy with the budgeted POST retries; base is
        # the healthy cadence, and the cap never drops below it (a down
        # control plane must not be probed faster than a healthy one).
        self._watch_backoff = ExpBackoff(
            base_s=max(poll_interval_s, 1e-6),
            max_s=max(backoff_max_s, poll_interval_s),
            rng=self._backoff_rng,
        )
        # Retry/drop observability (binding_retries / binding_drops /
        # watch_retries): counters live on an obs metrics registry —
        # every labeled child carries its own lock, so the two watch
        # threads and the scheduler thread publish without a shared
        # read-modify-write (tests/test_obs.py hammers this). The
        # default is a PRIVATE registry: stats() must be per-adapter
        # exact, and two adapters on a shared registry would alias the
        # same counter family. The service passes the process registry
        # explicitly (one adapter per process) so the counters also
        # serve on /metricsz; with obs disabled that falls back to a
        # private real Registry so stats() stays correct.
        reg = registry if registry is not None else Registry()
        if not isinstance(reg, Registry):  # e.g. handed the NullRegistry
            reg = Registry()
        self._events = reg.counter(
            "ksched_http_api_events_total",
            "control-plane adapter events (binding_retries, binding_drops, "
            "watch_retries)",
            labelnames=("event",),
        )
        # The channel+debounce layer is shared with the synthetic
        # control plane; this adapter only adds the HTTP watch/post.
        self._chan = SyntheticClusterAPI(pod_chan_size=pod_chan_size)
        self._seen_pods: Set[str] = set()
        self._seen_nodes: Set[str] = set()
        self._posted_bindings: dict = {}
        self._bindings_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._watch_pods, daemon=True),
            threading.Thread(target=self._watch_nodes, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- HTTP plumbing -----------------------------------------------------

    def _open(self, req_or_url, timeout: Optional[float] = None):
        return urllib.request.urlopen(
            req_or_url,
            timeout=self.request_timeout_s if timeout is None else timeout,
            context=self._ssl_ctx,
        )

    def _count(self, key: str, n: int = 1) -> None:
        self._events.labels(event=key).inc(n)

    def stats(self) -> Dict[str, int]:
        """Retry/drop counters (binding_retries, binding_drops,
        watch_retries) — the observability surface the round trace
        folds into RoundRecord.retries."""
        return {
            labels["event"]: int(child.value)
            for labels, child in self._events.samples()
        }

    def _backoff(self) -> ExpBackoff:
        return ExpBackoff(
            base_s=self.backoff_base_s,
            max_s=self.backoff_max_s,
            max_retries=self.retry_budget,
            rng=self._backoff_rng,
        )

    def _post_with_retry(self, req, retry_counter: str) -> None:
        """POST with exponential backoff + jitter under a retry budget.
        5xx and transport errors are transient (retried); 4xx are
        config/state errors and re-raise immediately. Raises the last
        error once the budget is spent."""
        backoff = self._backoff()
        while True:
            try:
                with self._open(req) as r:
                    r.read()
                return
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    raise
                err: Exception = e
            except (urllib.error.URLError, OSError) as e:
                err = e
            delay = backoff.next_delay()
            if delay is None:
                raise err
            self._count(retry_counter)
            if self._stop.wait(delay):
                raise err  # shutting down: stop retrying

    def _get_json(self, path: str) -> Optional[dict]:
        try:
            req = urllib.request.Request(
                self.base_url + path, headers=dict(self._auth_headers)
            )
            with self._open(req) as r:
                return json.loads(r.read().decode())
        except (urllib.error.URLError, OSError, json.JSONDecodeError):
            return None  # transient outage: informers keep retrying

    def _watch_wait(self, failure_streak: int) -> float:
        """Poll cadence with failure backoff: the normal interval while
        the server answers; exponentially longer (capped, jittered)
        across consecutive failures so a down control plane is probed,
        not hammered."""
        if failure_streak <= 0:
            return self.poll_interval_s
        # floor AFTER jitter: a downward draw must not probe a down
        # control plane faster than the healthy cadence
        return max(
            self.poll_interval_s,
            self._watch_backoff.delay_for(min(failure_streak, 8)),
        )

    # -- watch loops (informer analogue) -----------------------------------

    def _watch_pods(self) -> None:
        failure_streak = 0
        while not self._stop.wait(self._watch_wait(failure_streak)):
            got = self._get_json("/api/v1/pods?fieldSelector=spec.nodeName%3D%3D")
            if got is None:
                failure_streak += 1
                self._count("watch_retries")
                continue
            failure_streak = 0
            items = got.get("items", [])
            listed = {item["metadata"]["name"] for item in items}
            with self._bindings_lock:
                # Reconcile against the listing: a name that left the
                # pending set (bound, or deleted server-side) is
                # forgotten, so a pod re-created with the same name is
                # re-surfaced — and _seen_pods stays bounded by the
                # listing size instead of growing forever.
                self._seen_pods &= listed
                fresh = [
                    item for item in items
                    if item["metadata"]["name"] not in self._seen_pods
                ]
            for item in fresh:
                name = item["metadata"]["name"]
                spec = item.get("spec", {})
                event = PodEvent(
                    pod_id=name,
                    cpu_request=float(spec.get("cpu_request", 0.0)),
                    net_bw_request=int(spec.get("net_bw_request", 0)),
                    task_class=int(spec.get("task_class", 0)),
                )
                # bounded-wait offer so a full channel cannot wedge this
                # thread past close(); an unoffered pod is re-listed
                while not self._stop.is_set():
                    if self._chan.offer_pod(event, timeout_s=0.2):
                        with self._bindings_lock:
                            self._seen_pods.add(name)
                        break

    def _watch_nodes(self) -> None:
        failure_streak = 0
        while not self._stop.wait(self._watch_wait(failure_streak)):
            got = self._get_json("/api/v1/nodes")
            if got is None:  # transport failure — an empty listing is a healthy answer
                failure_streak += 1
                self._count("watch_retries")
                continue
            failure_streak = 0
            for item in got.get("items", []):
                if item.get("spec", {}).get("unschedulable"):
                    continue  # reference skips unschedulable nodes (:91-95)
                name = item["metadata"]["name"]
                if name in self._seen_nodes:
                    continue
                self._seen_nodes.add(name)
                cap = item.get("status", {}).get("capacity", {})
                self._chan.submit_node(
                    NodeEvent(
                        node_id=name,
                        num_cores=int(cap.get("cores", 1)),
                        pus_per_core=int(cap.get("pus_per_core", 1)),
                        net_bw_capacity=int(cap.get("net_bw", 0)),
                    )
                )

    # -- ClusterAPI --------------------------------------------------------

    def get_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        return self._chan.get_pod_batch(timeout_s)

    def poll_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        return self._chan.poll_pod_batch(timeout_s)

    def is_closed(self) -> bool:
        return self._stop.is_set()

    def get_node_batch(self, timeout_s: float) -> List[NodeEvent]:
        return self._chan.get_node_batch(timeout_s)

    def create_pod(self, pod_id: str, **spec) -> None:
        """Create a pod via the control plane (the podgen path: the
        reference's load generator POSTs pods to the API server,
        cmd/podgen/podgen.go:34-74). Posts exactly once; retry policy
        belongs to the caller — podgen already retries transient
        failures with backoff under its own budget, and an adapter-level
        retry layer underneath it would multiply worst-case attempts
        (budget × budget) and stack two backoff schedules."""
        body = json.dumps(
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": pod_id}, "spec": spec}
        ).encode()
        req = urllib.request.Request(
            f"{self.base_url}/api/v1/namespaces/{self.namespace}/pods",
            data=body,
            headers={"Content-Type": "application/json", **self._auth_headers},
            method="POST",
        )
        with self._open(req) as r:
            r.read()

    def bindings(self) -> dict:
        """Pod→node placements this adapter successfully posted."""
        with self._bindings_lock:
            return dict(self._posted_bindings)

    def assign_bindings(self, bindings: List[Binding]) -> None:
        for b in bindings:
            body = json.dumps(
                {
                    "apiVersion": "v1",
                    "kind": "Binding",
                    "metadata": {"name": b.pod_id},
                    "target": {"apiVersion": "v1", "kind": "Node", "name": b.node_id},
                }
            ).encode()
            req = urllib.request.Request(
                f"{self.base_url}/api/v1/namespaces/{self.namespace}"
                f"/pods/{b.pod_id}/binding",
                data=body,
                headers={"Content-Type": "application/json", **self._auth_headers},
                method="POST",
            )
            try:
                self._post_with_retry(req, "binding_retries")
            except (urllib.error.URLError, OSError):
                # Retry budget spent (or a 4xx): the reference logs and
                # moves on (client.go:141-146); the pod stays pending
                # and re-enters a later batch, where the service's
                # re-deliver machinery re-emits the binding.
                self._count("binding_drops")
                with self._bindings_lock:
                    self._seen_pods.discard(b.pod_id)
            else:
                with self._bindings_lock:
                    self._posted_bindings[b.pod_id] = b.node_id

    def close(self) -> None:
        self._stop.set()
        self._chan.close()
        for t in self._threads:
            t.join(timeout=2)
