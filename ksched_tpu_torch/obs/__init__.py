"""ksched_tpu_torch.obs: the observability subsystem (port of
ksched_tpu/obs, exporting the same names).

- **metrics** — a process-wide registry of Counters, Gauges, and
  log-bucketed Histograms with labels;
- **spans** — contextvar-based hierarchical span tracing whose output
  is Chrome/Perfetto trace-event JSON; `RoundTiming` is derived from
  these spans;
- **exporter** — Prometheus text-format exposition from a stdlib HTTP
  thread (`/metricsz`, `/healthz`, `/varz`) plus dump-on-exit;
- **devprof** — device-side accounting (per-solve superstep and rung
  counters, host→device bytes per round, an opt-in `torch.profiler`
  capture around the Nth solve);
- **flight** — a crash flight recorder: the last N rounds' records and
  spans, dumped on deadline miss, ladder exhaustion, or crash;
- **soltel** — solver-interior telemetry: per-superstep device
  counters written by the solves (kernel B3 included), decoded into the
  registry, synthesized as per-superstep child spans, and fed to a
  structured stall detector whose events ride in flight dumps.

`KSCHED_OBS=0` (or `metrics.set_enabled(False)`) switches the global
registry to an inert null registry and turns the telemetry rings off;
`KSCHED_SOLTEL=0` turns off only the rings. Both default to on.
"""

from .devprof import DeviceProfiler, get_profiler, set_profiler
from .exporter import (
    MetricsServer,
    dump_registry,
    parse_prometheus,
    render_prometheus,
    scrape,
)
from .flight import FlightRecorder
from .metrics import (
    DEFAULT_MS_BUCKETS,
    NULL_METRIC,
    NULL_REGISTRY,
    Registry,
    ScopedRegistry,
    enabled,
    get_registry,
    log_buckets,
    scoped_registry,
    set_enabled,
    set_registry,
)
from .soltel import (
    SOLTEL_COLS,
    SOLTEL_DEFAULT_CAP,
    SOLTEL_TAIL,
    SOLTEL_WIDTH,
    SolverStallError,
    SolveTelemetry,
    detect_stall,
)
from .spans import Span, SpanTracer, active_tracer, span, start_span

__all__ = [
    "DEFAULT_MS_BUCKETS",
    "DeviceProfiler",
    "FlightRecorder",
    "MetricsServer",
    "NULL_METRIC",
    "NULL_REGISTRY",
    "Registry",
    "ScopedRegistry",
    "SOLTEL_COLS",
    "SOLTEL_DEFAULT_CAP",
    "SOLTEL_TAIL",
    "SOLTEL_WIDTH",
    "SolveTelemetry",
    "SolverStallError",
    "Span",
    "SpanTracer",
    "active_tracer",
    "detect_stall",
    "dump_registry",
    "enabled",
    "get_profiler",
    "get_registry",
    "log_buckets",
    "parse_prometheus",
    "render_prometheus",
    "scoped_registry",
    "scrape",
    "set_enabled",
    "set_profiler",
    "set_registry",
    "span",
    "start_span",
]
