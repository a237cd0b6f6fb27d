"""Prometheus text-format exposition + the stdlib metrics HTTP server.

Port of ksched_tpu/obs/exporter.py (stdlib only).

Serves three routes from a daemon thread (no dependencies beyond
`http.server`):

- ``/metricsz`` — Prometheus text format 0.0.4 (HELP/TYPE lines, label
  escaping, cumulative ``_bucket`` series with ``+Inf``, ``_sum`` and
  ``_count``);
- ``/healthz``  — liveness JSON (status + uptime);
- ``/varz``     — the registry snapshot as JSON (the machine-readable
  twin of /metricsz, same shape as the dump-on-exit artifact).

`render_prometheus` / `parse_prometheus` are exposed separately so the
soak's obs smoke can scrape its own endpoint and reconcile the served
text against the RoundRecord JSONL, and so conformance tests can
round-trip escaping without a socket.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from .metrics import Registry, get_registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(bound) -> str:
    return "+Inf" if bound == "+Inf" else _fmt(float(bound))


def _labels_text(labels: Dict[str, str], extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in items)
    return "{" + body + "}"


def render_prometheus(registry: Registry) -> str:
    """The registry as Prometheus exposition text."""
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.samples():
            if fam.kind == "histogram":
                bounds, counts, total_sum, total_count = child.snapshot()
                cum = 0
                for bound, n in zip(list(bounds) + ["+Inf"], counts):
                    cum += n
                    lt = _labels_text(labels, ("le", _fmt_le(bound)))
                    lines.append(f"{fam.name}_bucket{lt} {cum}")
                lt = _labels_text(labels)
                lines.append(f"{fam.name}_sum{lt} {_fmt(total_sum)}")
                lines.append(f"{fam.name}_count{lt} {total_count}")
            else:
                lines.append(f"{fam.name}{_labels_text(labels)} {_fmt(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def _parse_labels(body: str) -> Dict[str, str]:
    """Parse `a="x",b="y"` with Prometheus label-value escapes."""
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        name = body[i:eq].strip().lstrip(",").strip()
        assert body[eq + 1] == '"', f"malformed label at {body[i:]!r}"
        j = eq + 2
        out = []
        while body[j] != '"':
            ch = body[j]
            if ch == "\\":
                j += 1
                nxt = body[j]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
            else:
                out.append(ch)
            j += 1
        labels[name] = "".join(out)
        i = j + 1
    return labels


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Exposition text → {(series_name, sorted label items): value}.

    Series names include the `_bucket`/`_sum`/`_count` suffixes as
    written. Used by conformance tests and the soak's live-scrape
    reconciliation; not a general-purpose Prometheus parser."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # value is after the last space not inside braces; label values
        # may contain spaces, so split from the right of the brace
        if "}" in line:
            brace = line.index("{")
            endbrace = line.rindex("}")
            name = line[:brace]
            labels = _parse_labels(line[brace + 1:endbrace])
            value = float(line[endbrace + 1:].strip())
        else:
            name, value_s = line.rsplit(" ", 1)
            name = name.strip()
            labels = {}
            value = float(value_s)
        out[(name, tuple(sorted(labels.items())))] = value
    return out


def dump_registry(registry: Registry, path: str) -> None:
    """Dump-on-exit artifact: the registry snapshot as JSON."""
    with open(path, "w") as f:
        json.dump(
            {"captured_at": time.time(), "metrics": registry.snapshot()},
            f,
            indent=1,
        )


def scrape(url: str, timeout_s: float = 5.0) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """GET a /metricsz URL and parse it (the obs smoke's 'curl')."""
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return parse_prometheus(r.read().decode())


class MetricsServer:
    """The observability endpoint: a ThreadingHTTPServer on a daemon
    thread serving /metricsz, /healthz, /varz. ``port=0`` binds an
    ephemeral port (CI-safe); the bound port is ``self.port``."""

    def __init__(
        self,
        port: int = 0,
        registry: Optional[Registry] = None,
        host: str = "127.0.0.1",
    ) -> None:
        self.registry = registry if registry is not None else get_registry()
        self._t0 = time.monotonic()
        server_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr spam
                pass

            def _send(self, code: int, content_type: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/metricsz", "/metrics"):
                    body = render_prometheus(server_self.registry).encode()
                    self._send(200, PROMETHEUS_CONTENT_TYPE, body)
                elif path == "/healthz":
                    body = json.dumps(
                        {
                            "status": "ok",
                            "uptime_s": time.monotonic() - server_self._t0,
                        }
                    ).encode()
                    self._send(200, "application/json", body)
                elif path == "/varz":
                    body = json.dumps(server_self.registry.snapshot()).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found\n")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ksched-metrics", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
