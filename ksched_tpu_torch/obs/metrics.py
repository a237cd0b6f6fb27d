"""Process-wide metrics registry: Counters, Gauges, log-bucketed
Histograms with label support.

Port of ksched_tpu/obs/metrics.py (stdlib only; the port keeps its own
copy). Every layer of the port publishes here — the device profiler
(obs/devprof.py), the solver-interior telemetry (obs/soltel.py), the
flight recorder (obs/flight.py) — and obs/exporter.py serves it as
Prometheus text.

Design constraints, in order:

1. **Hot-path cheap.** A metric update is one dict lookup plus one
   locked float add; handles are cached by the instrumented layers so
   the name→family resolution is not repeated per round.
2. **Thread-safe.** Every child metric carries its own lock; families
   guard their children dict, so an exporter thread and the scheduler
   thread can publish and read concurrently.
3. **No-op-able.** `set_enabled(False)` (or env `KSCHED_OBS=0`) makes
   `get_registry()` hand out a null registry whose metrics are inert
   singletons, so a process that doesn't want observability pays a
   single attribute read per update site.

Registries are also first-class objects: tests create private
`Registry()` instances (or push one with `scoped_registry`) so per-run
accounting is exact even with the process-global registry in use
elsewhere.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> Tuple[float, ...]:
    """Log-spaced histogram bounds: lo, lo*factor, ... up to >= hi."""
    if lo <= 0 or factor <= 1:
        raise ValueError("log_buckets needs lo > 0 and factor > 1")
    out: List[float] = []
    b = float(lo)
    while b < hi * (1 + 1e-12):
        out.append(b)
        b *= factor
    return tuple(out)


#: default bounds for millisecond timings: ~1 us to ~67 s, factor 2
DEFAULT_MS_BUCKETS = log_buckets(1e-3, 1 << 16, 2.0)


class Counter:
    """A monotone counter (one labeled child)."""

    kind = "counter"
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A set/inc/dec value (one labeled child)."""

    kind = "gauge"
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """A log-bucketed histogram (one labeled child).

    Bucket semantics are Prometheus `le`: a sample lands in the first
    bucket whose bound is >= the value; counts are kept per-bucket here
    and cumulated at export time (obs/exporter.py)."""

    kind = "histogram"
    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BUCKETS) -> None:
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError("histogram bounds must be non-empty, sorted, unique")
        self._lock = threading.Lock()
        self.bounds = b
        self._counts = [0] * (len(b) + 1)  # +1 for the +Inf overflow bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        """(bounds, per-bucket counts incl. +Inf, sum, count), atomically."""
        with self._lock:
            return self.bounds, list(self._counts), self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


_CHILD_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """A named metric family: the (name, kind, labelnames) triple plus
    its labeled children. Unlabeled families proxy the child API
    directly (``family.inc()``), so call sites don't special-case."""

    def __init__(
        self,
        name: str,
        help: str = "",
        kind: str = "counter",
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} for metric {name!r}")
        if kind not in _CHILD_KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        if buckets is not None and kind != "histogram":
            raise ValueError(f"buckets= only applies to histograms ({name!r})")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets is not None else None
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self._buckets if self._buckets is not None else DEFAULT_MS_BUCKETS)
        return _CHILD_KINDS[self.kind]()

    def labels(self, *values, **kv):
        """Get-or-create the child for one label-value combination.
        Values are coerced to str (label values are strings on the
        wire); positional and keyword forms both work."""
        if kv:
            if values:
                raise ValueError("pass label values positionally or by name, not both")
            try:
                values = tuple(kv[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for metric {self.name!r}") from e
            if len(kv) != len(self.labelnames):
                extra = set(kv) - set(self.labelnames)
                raise ValueError(f"unknown labels {sorted(extra)} for metric {self.name!r}")
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, got {key}"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels dict, child)] for every materialized child, in
        insertion order (stable for the text exposition)."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child) for key, child in items]

    # -- unlabeled proxy ---------------------------------------------------

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}; use .labels()"
            )
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._unlabeled().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._unlabeled().dec(n)

    def set(self, v: float) -> None:
        self._unlabeled().set(v)

    def observe(self, v: float) -> None:
        self._unlabeled().observe(v)

    @property
    def value(self) -> float:
        return self._unlabeled().value

    @property
    def count(self) -> int:
        return self._unlabeled().count

    @property
    def sum(self) -> float:
        return self._unlabeled().sum


class Registry:
    """A set of metric families. `counter`/`gauge`/`histogram` are
    get-or-create: re-requesting an existing name returns the same
    family (so modules can be re-instantiated), but a kind, label, or
    bucket mismatch is a hard error — silent aliasing would corrupt
    both."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _get_or_create(self, name, help, kind, labelnames, buckets=None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, help, kind, labelnames, buckets)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with labels "
                f"{fam.labelnames}; requested {kind} with {tuple(labelnames)}"
            )
        if kind == "histogram" and buckets is not None:
            # buckets are as identity-bearing as kind/labels: silently
            # landing samples in bounds the caller did not ask for would
            # skew every percentile estimated from them
            effective = (
                fam._buckets if fam._buckets is not None else DEFAULT_MS_BUCKETS
            )
            if tuple(float(b) for b in buckets) != effective:
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{effective}; requested {tuple(buckets)}"
                )
        return fam

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Family:
        return self._get_or_create(name, help, "histogram", labelnames, buckets)

    def collect(self) -> List[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def value(self, name: str, **labels) -> float:
        """Read one sample (0.0 when absent) — the test/stats accessor."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            return 0.0
        key = tuple(str(labels[ln]) for ln in fam.labelnames if ln in labels)
        if len(key) != len(fam.labelnames):
            raise ValueError(f"metric {name!r} needs labels {fam.labelnames}")
        with fam._lock:
            child = fam._children.get(key)
        if child is None:
            return 0.0
        if fam.kind == "histogram":
            return float(child.count)
        return float(child.value)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able dump of every family and sample (the /varz body and
        the dump-on-exit artifact)."""
        out: Dict[str, dict] = {}
        for fam in self.collect():
            samples = []
            for lbl, child in fam.samples():
                if fam.kind == "histogram":
                    bounds, counts, s, c = child.snapshot()
                    samples.append(
                        {
                            "labels": lbl,
                            "count": c,
                            "sum": s,
                            "buckets": [
                                [b, n] for b, n in zip(list(bounds) + ["+Inf"], counts)
                            ],
                        }
                    )
                else:
                    samples.append({"labels": lbl, "value": child.value})
            out[fam.name] = {
                "kind": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "samples": samples,
            }
        return out


class _NullMetric:
    """Inert metric/family singleton: every mutator is a no-op, every
    reader is zero. `labels()` returns itself so labeled call sites
    need no branching."""

    __slots__ = ()
    kind = "null"
    name = "null"
    labelnames = ()

    def labels(self, *a, **k):
        return self

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def samples(self):
        return []


NULL_METRIC = _NullMetric()


class NullRegistry:
    """The disabled-observability registry: hands out NULL_METRIC and
    exports nothing."""

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        return NULL_METRIC

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        return NULL_METRIC

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return NULL_METRIC

    def collect(self) -> List[Family]:
        return []

    def value(self, name: str, **labels) -> float:
        return 0.0

    def snapshot(self) -> Dict[str, dict]:
        return {}


NULL_REGISTRY = NullRegistry()


class _BoundFamily:
    """A Family view with a constant label prefix pre-bound — what a
    ``ScopedRegistry`` hands out. The scope labels (e.g. ``tenant``)
    come FIRST in the parent family's labelnames; the view re-exposes
    the caller's own labelnames exactly as requested, so instrumented
    code is scope-oblivious: ``fam.labels(kind="noop").inc()`` works
    identically whether ``fam`` came from a plain Registry or a
    tenant-scoped view."""

    __slots__ = ("_family", "_scope_values", "_labelnames")

    def __init__(self, family: Family, scope_values: Tuple[str, ...], labelnames: Tuple[str, ...]) -> None:
        self._family = family
        self._scope_values = scope_values
        self._labelnames = tuple(labelnames)

    @property
    def name(self) -> str:
        return self._family.name

    @property
    def kind(self) -> str:
        return self._family.kind

    @property
    def labelnames(self) -> Tuple[str, ...]:
        return self._labelnames

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally or by name, not both")
            try:
                values = tuple(kv[ln] for ln in self._labelnames)
            except KeyError as e:
                raise ValueError(
                    f"missing label {e} for metric {self._family.name!r}"
                ) from e
            if len(kv) != len(self._labelnames):
                extra = set(kv) - set(self._labelnames)
                raise ValueError(
                    f"unknown labels {sorted(extra)} for metric {self._family.name!r}"
                )
        if len(values) != len(self._labelnames):
            raise ValueError(
                f"metric {self._family.name!r} takes labels {self._labelnames}, "
                f"got {tuple(values)}"
            )
        return self._family.labels(*(self._scope_values + tuple(str(v) for v in values)))

    # -- unlabeled proxy (scope-only child) --------------------------------

    def _scope_child(self):
        if self._labelnames:
            raise ValueError(
                f"metric {self._family.name!r} has labels {self._labelnames}; use .labels()"
            )
        return self._family.labels(*self._scope_values)

    def inc(self, n: float = 1.0) -> None:
        self._scope_child().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._scope_child().dec(n)

    def set(self, v: float) -> None:
        self._scope_child().set(v)

    def observe(self, v: float) -> None:
        self._scope_child().observe(v)

    @property
    def value(self) -> float:
        return self._scope_child().value

    @property
    def count(self) -> int:
        return self._scope_child().count

    @property
    def sum(self) -> float:
        return self._scope_child().sum


class ScopedRegistry:
    """A labelled child view of a parent Registry: every family
    requested through it is created on the PARENT with the scope
    labelnames prepended, and the returned handle pre-binds the scope
    values. This is how the multi-tenant service gives each tenant its
    own accounting without N private registries: one shared parent, one
    ``tenant`` label, and scope-oblivious instrumented layers.

    Unlike the old swap-in/swap-out pattern, concurrent scoped views
    are safe by construction — they never mutate process state, and the
    parent's families/children carry their own locks."""

    def __init__(self, parent: Registry, labels: Dict[str, str]) -> None:
        if not labels:
            raise ValueError("ScopedRegistry needs at least one scope label")
        for ln in labels:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid scope label name {ln!r}")
        self.parent = parent
        self.scope_labels = dict(labels)
        self._names = tuple(labels.keys())
        self._values = tuple(str(v) for v in labels.values())

    def scoped(self, **labels) -> "ScopedRegistry":
        """Nested scope: labels accumulate (outer first)."""
        merged = dict(self.scope_labels)
        merged.update(labels)
        return ScopedRegistry(self.parent, merged)

    def _family(self, kind: str, name, help, labelnames, buckets=None) -> _BoundFamily:
        overlap = set(self._names) & set(labelnames)
        if overlap:
            raise ValueError(
                f"metric {name!r} labelnames {tuple(labelnames)} collide with "
                f"scope labels {sorted(overlap)}"
            )
        full = self._names + tuple(labelnames)
        fam = self.parent._get_or_create(name, help, kind, full, buckets)
        return _BoundFamily(fam, self._values, tuple(labelnames))

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._family("histogram", name, help, labelnames, buckets)

    def value(self, name: str, **labels) -> float:
        """Read one sample within this scope (0.0 when absent)."""
        return self.parent.value(name, **{**self.scope_labels, **labels})

    def collect(self) -> List[Family]:
        return self.parent.collect()

    def snapshot(self) -> Dict[str, dict]:
        return self.parent.snapshot()


def _registry_scoped(self: Registry, **labels) -> ScopedRegistry:
    """``reg.scoped(tenant="t3")`` — a labelled child view (see
    ScopedRegistry)."""
    return ScopedRegistry(self, labels)


Registry.scoped = _registry_scoped  # type: ignore[attr-defined]

_default_registry = Registry()
_enabled = os.environ.get("KSCHED_OBS", "1").lower() not in ("0", "false", "off")
#: thread-local registry overlay: scoped_registry pushes here, so two
#: threads (e.g. two soak runs, or a test harness around a live
#: service) can hold DIFFERENT scoped registries concurrently without
#: clobbering each other through the process global — the multi-tenant
#: loop's safety requirement
_tls = threading.local()


def set_enabled(on: bool) -> None:
    """Globally enable/disable observability. Disabled means
    `get_registry()` returns the null registry; handles already taken
    from the real registry keep working (they are plain objects)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def get_registry() -> Registry:
    """The active registry: the calling thread's scoped overlay if one
    is entered, else the process global (or the null registry when obs
    is disabled). Layers that want exact per-run accounting (the soak,
    tests) construct private Registry() instances instead — or push one
    with `scoped_registry`."""
    if not _enabled:
        return NULL_REGISTRY  # type: ignore[return-value]
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return _default_registry


def set_registry(reg: Registry) -> Registry:
    """Replace the PROCESS-GLOBAL registry; returns the previous one.
    This is the cross-thread-visible swap (threads started afterwards
    see it); thread-confined scoping should use `scoped_registry`,
    which never touches process state.

    Instrumented layers resolve their metric handles at CONSTRUCTION
    time (never at import time), so swapping before building a service
    gives that run a private accounting surface."""
    global _default_registry
    prev = _default_registry
    _default_registry = reg
    return prev


class scoped_registry:
    """``with scoped_registry() as reg:`` — push a fresh (or given)
    registry for the block and restore the previous one after. The
    soak's determinism double-run uses this so each run's counters
    start from zero instead of accumulating in the global registry.

    Since the multi-tenant work this is THREAD-CONFINED and reentrant:
    the registry is pushed onto a thread-local stack (read by
    `get_registry`), so nested scopes compose and concurrent scopes in
    different threads cannot clobber each other — the process-global
    swap-in/swap-out this replaces was neither. Threads SPAWNED inside
    the scope see the process global; pass the registry explicitly
    (every obs component takes a ``registry=`` argument) when a worker
    thread must publish into a scope."""

    def __init__(self, reg: Optional[Registry] = None) -> None:
        self.registry = reg if reg is not None else Registry()

    def __enter__(self) -> Registry:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.registry)
        return self.registry

    def __exit__(self, *exc) -> None:
        stack = getattr(_tls, "stack", None)
        if not stack or stack[-1] is not self.registry:
            raise RuntimeError(
                "scoped_registry exited out of order (exit must happen on "
                "the thread — and in the nesting order — that entered it)"
            )
        stack.pop()
