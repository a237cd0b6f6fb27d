"""A loopback fake API server speaking the slice of the k8s API the
scheduler uses: pending-pod listing (field-selector semantics), node
listing, and the Binding subresource POST. Lets the HTTP adapter
(cluster/http_api.py) and the scheduler service run end-to-end over
real sockets with no cluster — the hermetic analogue of running the
reference against a bare kube-apiserver with no kubelets
(reference README.md:55-70).

Side-door endpoints (prefixed /_test) play podgen and the node
lifecycle: POST /_test/pods {"count": N}, POST /_test/nodes {...},
GET /_test/bindings.

Hermetic fault hooks: `fault_hook` (constructor arg or
`set_fault_hook`) is consulted once per API request with a route kind
("list_pods" | "list_nodes" | "bind" | "create_pod"; /_test side-door
routes are never faulted) and may return
``{"kind": "error", "code": 503}`` (respond with that status),
``{"kind": "latency", "seconds": s}`` (sleep, then serve normally), or
``{"kind": "hang", "seconds": s}`` (sleep, then drop the connection
with no response — the client sees a timeout/connection error). A
`runtime.chaos.FaultInjector.http_fault` plugs in directly, giving
seeded 5xx/hang/latency schedules over real sockets.
"""

from __future__ import annotations

import json
import ssl
import subprocess
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, Dict, List, Optional


#: process-wide cert cache: one keygen (+ one auto-cleaned temp dir)
#: shared by every TLS-mode server in the process
_CERT_DIR: Optional[tempfile.TemporaryDirectory] = None
_CERT_PATHS: Optional[tuple] = None


def make_self_signed_cert(directory: Optional[str] = None):
    """(cert_path, key_path) for a 127.0.0.1 self-signed cert, via the
    system openssl CLI (hermetic TLS tests; no cryptography dep).
    Without `directory`, the pair is generated once per process into a
    TemporaryDirectory cleaned up at interpreter exit — RSA keygen
    costs ~100 ms and every FakeAPIServer(tls=True) would otherwise
    leak a fresh /tmp dir."""
    global _CERT_DIR, _CERT_PATHS
    if directory is None and _CERT_PATHS is not None:
        return _CERT_PATHS
    if directory is None:
        _CERT_DIR = tempfile.TemporaryDirectory(prefix="ksched_tls_")
        d = Path(_CERT_DIR.name)
    else:
        d = Path(directory)
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", str(key), "-out", str(cert),
            "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
            "-addext", "subjectAltName=IP:127.0.0.1",
        ],
        check=True, capture_output=True,
    )
    if directory is None:
        _CERT_PATHS = (str(cert), str(key))
        return _CERT_PATHS
    return str(cert), str(key)


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.pods: Dict[str, dict] = {}  # name -> spec
        self.nodes: List[dict] = []
        self.bindings: Dict[str, str] = {}  # pod -> node
        #: (route_kind) -> None | {"kind": "error"|"hang"|"latency", ...};
        #: mutable at runtime so tests flip faults on and off mid-flight
        self.fault_hook: Optional[Callable[[str], Optional[dict]]] = None

    # shared by the HTTP handlers and the Python side-door so the two
    # entry points cannot drift on object schema
    def add_node(self, name: str, capacity: dict, unschedulable: bool) -> None:
        with self.lock:
            self.nodes.append(
                {
                    "metadata": {"name": name},
                    "spec": {"unschedulable": bool(unschedulable)},
                    "status": {"capacity": dict(capacity)},
                }
            )

    def add_pods(self, count: int, prefix: str, spec: dict) -> None:
        with self.lock:
            start = len(self.pods)
            for i in range(count):
                self.pods[f"{prefix}_{start + i}"] = dict(spec)


class _Handler(BaseHTTPRequestHandler):
    state: _State  # set by FakeAPIServer
    bearer: Optional[str] = None  # require this token when set

    def log_message(self, *args) -> None:  # silence request logging
        pass

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n).decode()) if n else {}

    def _authorized(self) -> bool:
        if self.bearer is None:
            return True
        if self.headers.get("Authorization") == f"Bearer {self.bearer}":
            return True
        self._json(401, {"error": "unauthorized"})
        return False

    def _faulted(self, route: str) -> bool:
        """Consult the fault hook; True = the request was consumed by an
        injected fault and no normal handling should run."""
        hook = self.state.fault_hook
        if hook is None:
            return False
        action = hook(route)
        if action is None:
            return False
        kind = action.get("kind")
        if kind == "error":
            self._json(int(action.get("code", 503)), {"error": "chaos: injected fault"})
            return True
        if kind == "hang":
            # stall, then drop the connection without a response: the
            # client experiences a hung request ending in a transport
            # error (its timeout must be the bound, not our sleep)
            time.sleep(float(action.get("seconds", 1.0)))
            self.close_connection = True
            return True
        if kind == "latency":
            time.sleep(float(action.get("seconds", 0.05)))
            return False  # spike absorbed; serve normally
        raise ValueError(f"unknown fault action {action!r}")

    def do_GET(self) -> None:
        if not self._authorized():
            return
        st = self.state
        if self.path.startswith("/api/v1/pods"):
            if self._faulted("list_pods"):
                return
            with st.lock:
                # field-selector semantics: only pods not yet bound
                items = [
                    {"metadata": {"name": name}, "spec": spec}
                    for name, spec in st.pods.items()
                    if name not in st.bindings
                ]
            self._json(200, {"kind": "PodList", "items": items})
        elif self.path.startswith("/api/v1/nodes"):
            if self._faulted("list_nodes"):
                return
            with st.lock:
                items = list(st.nodes)
            self._json(200, {"kind": "NodeList", "items": items})
        elif self.path == "/_test/bindings":
            with st.lock:
                self._json(200, dict(st.bindings))
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:
        if not self._authorized():
            return
        st = self.state
        parts = self.path.strip("/").split("/")
        # /api/v1/namespaces/{ns}/pods/{name}/binding
        if (
            len(parts) == 7
            and parts[:3] == ["api", "v1", "namespaces"]
            and parts[4] == "pods"
            and parts[6] == "binding"
        ):
            if self._faulted("bind"):
                return
            body = self._read_body()
            pod = parts[5]
            node = body.get("target", {}).get("name", "")
            with st.lock:
                if pod not in st.pods:
                    return self._json(404, {"error": f"pod {pod} not found"})
                st.bindings[pod] = node
            return self._json(201, {"kind": "Status", "status": "Success"})
        # /api/v1/namespaces/{ns}/pods — pod creation (the podgen path,
        # cmd/podgen/podgen.go:34-74 creates pods via the API server)
        if (
            len(parts) == 5
            and parts[:3] == ["api", "v1", "namespaces"]
            and parts[4] == "pods"
        ):
            if self._faulted("create_pod"):
                return
            body = self._read_body()
            name = body.get("metadata", {}).get("name")
            if not name:
                return self._json(400, {"error": "metadata.name required"})
            with st.lock:
                st.pods[name] = dict(body.get("spec", {}))
            return self._json(201, {"kind": "Pod", "metadata": {"name": name}})
        if self.path == "/_test/pods":
            body = self._read_body()
            count = int(body.get("count", 1))
            st.add_pods(count, body.get("prefix", "pod"), body.get("spec", {}))
            return self._json(201, {"created": count})
        if self.path == "/_test/nodes":
            body = self._read_body()
            st.add_node(
                body["name"], body.get("capacity", {}),
                bool(body.get("unschedulable")),
            )
            return self._json(201, {"ok": True})
        self._json(404, {"error": f"no route {self.path}"})


class FakeAPIServer:
    """Threaded loopback server; `base_url` after start().

    `tls=True` serves https with a freshly generated self-signed
    127.0.0.1 cert (`ca_cert_path` is what clients should pin);
    `bearer` requires `Authorization: Bearer <token>` on every route
    (401 otherwise) — the hermetic stand-in for a kube-apiserver with
    token auth (the reference's client is built with credentials,
    k8s/k8sclient/client.go:34-42)."""

    def __init__(
        self,
        tls: bool = False,
        bearer: Optional[str] = None,
        fault_hook: Optional[Callable[[str], Optional[dict]]] = None,
    ) -> None:
        self._state = _State()
        self._state.fault_hook = fault_hook
        handler = type(
            "Handler", (_Handler,), {"state": self._state, "bearer": bearer}
        )
        self._tls = bool(tls)
        self.ca_cert_path: Optional[str] = None
        if tls:
            cert, key = make_self_signed_cert()
            self.ca_cert_path = cert
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)

            class _TLSServer(ThreadingHTTPServer):
                # Per-CONNECTION wrap with a handshake timeout, run on
                # the per-connection handler thread (finish_request),
                # NOT the accept thread: a client that stalls its
                # handshake must cost only its own connection, not
                # serialize every other accept behind its 5 s timeout.
                # (Wrapping the listening socket would be worse still:
                # handshakes with no timeout inside serve_forever, and
                # a failed handshake raising out of the serve loop.)
                # wrap_socket detaches the raw socket's fd into the SSL
                # socket, so the caller's shutdown_request on the raw
                # socket is a no-op; the wrapper is closed here.
                def finish_request(self_inner, request, client_address):
                    request.settimeout(5)
                    try:
                        tls_sock = ctx.wrap_socket(request, server_side=True)
                    except (ssl.SSLError, OSError):
                        request.close()
                        return
                    try:
                        self_inner.RequestHandlerClass(
                            tls_sock, client_address, self_inner
                        )
                    finally:
                        tls_sock.close()

            self._httpd = _TLSServer(("127.0.0.1", 0), handler)
        else:
            self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def base_url(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> "FakeAPIServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)

    def set_fault_hook(
        self, hook: Optional[Callable[[str], Optional[dict]]]
    ) -> None:
        """Install (or clear, with None) the per-request fault hook —
        e.g. a FaultInjector's ``http_fault`` — at runtime."""
        self._state.fault_hook = hook

    # -- convenience for tests/demos (the podgen/node side-door) -----------

    def add_node(self, name: str, cores: int = 1, pus_per_core: int = 1,
                 unschedulable: bool = False) -> None:
        self._state.add_node(
            name, {"cores": cores, "pus_per_core": pus_per_core}, unschedulable
        )

    def create_pods(self, count: int, prefix: str = "pod", **spec) -> None:
        self._state.add_pods(count, prefix, spec)

    def bindings(self) -> Dict[str, str]:
        with self._state.lock:
            return dict(self._state.bindings)

    def pending_pods(self) -> int:
        with self._state.lock:
            return sum(
                1 for p in self._state.pods if p not in self._state.bindings
            )
