"""Solver-interior telemetry: per-superstep device counters, decoded.

Port of ksched_tpu/obs/soltel.py. Every general-graph backend of the
port (the scan-CSR `csr_solver`, the `mega` kernel B3 and its plain
version, `ell`) and the layered transport's plain loop can emit a
fixed-size, superstep-indexed telemetry ring beside its flows, written
ON THE DEVICE (a row written in place at each superstep, or from inside
kernel B3), with no extra host reads — the ring rides back with the
flow fetch — and bit-identical flows when disabled (the counters read
state the superstep already computed; they never feed back into it).

Buffer layout (`SOLTEL_COLS`, int32 `[cap, SOLTEL_WIDTH]`):

| col | name      | meaning (per executed superstep)                     |
|-----|-----------|------------------------------------------------------|
| 0   | eps       | the cost-scaling phase's eps at this superstep       |
| 1   | active    | nodes with positive excess entering the superstep    |
| 2   | excess    | total positive excess (units still to discharge)     |
| 3   | pushed    | flow units moved by this superstep's maximal pushes  |
| 4   | relabels  | nodes relabeled (active, nothing pushed)             |
| 5   | saturated | forward residual arcs at zero residual               |
| 6   | work      | admissible residual entries (the discharge frontier) |
| 7   | —         | reserved (padding keeps the row pow2-wide)           |

Sums are int32 with wrap-around, as in the JAX package. Rows are
written RING-STYLE at `step % cap`, so when a solve exceeds the buffer
the LAST `cap` supersteps survive — exactly the window a stall
post-mortem needs. Truncation is explicit: `SolveTelemetry.truncated`
+ `start_step` say precisely which supersteps the rows cover.

Host side (a copy of the JAX package's):

- `decode()` unrolls the ring into superstep order;
- `publish()` feeds the registry (`ksched_solve_supersteps{backend}`,
  per-eps-phase superstep histograms, pushed/relabeled totals) and —
  when a SpanTracer is active — synthesizes per-superstep child spans
  under the open `backend_solve` span;
- `detect_stall()` is the stall/divergence detector: K supersteps
  without excess decrease, an eps plateau, or superstep-cap proximity
  each yield a structured reason dict;
- `note_stall()` keeps a bounded ring of structured stall events that
  `obs.flight.FlightRecorder.dump` embeds in every flight dump
  (`solver_stalls`), and `failure_reason()` turns a failed solve into a
  structured reason with the final `SOLTEL_TAIL` supersteps attached.

`KSCHED_SOLTEL=0` (or `set_enabled(False)`) resolves every solver's
default telemetry capacity to 0; `KSCHED_OBS=0` does too. Both are read
once, at import, with the JAX package's names and defaults (on).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .metrics import get_registry, log_buckets

#: counter taxonomy; column 7 is reserved padding (pow2-wide rows)
SOLTEL_COLS = (
    "eps", "active", "excess", "pushed", "relabels", "saturated", "work",
)
SOLTEL_WIDTH = 8

#: default ring capacity (supersteps kept); solvers may clamp it down
#: (the megakernel bounds the buffer to one VMEM tile)
SOLTEL_DEFAULT_CAP = 512

#: supersteps of telemetry attached to structured stall/failure events
SOLTEL_TAIL = 32

#: window for the no-excess-decrease stall rule
SOLTEL_STALL_WINDOW = 64

#: superstep-count histogram bounds (1 .. 131072, factor 2)
COUNT_BUCKETS = log_buckets(1.0, 1 << 17, 2.0)

_enabled = os.environ.get("KSCHED_SOLTEL", "1").lower() not in (
    "0", "false", "off"
)


def set_enabled(on: bool) -> None:
    """Enable/disable solver-interior telemetry process-wide. Solvers
    resolve their capacity PER SOLVE via `resolve_cap`, so flipping
    this takes effect on the next solve (at the cost of one recompile
    per toggled executable)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def resolve_cap(override: Optional[int]) -> int:
    """The telemetry buffer capacity a solver should use: an explicit
    constructor override wins; otherwise the module default — 0 when
    soltel is disabled OR all of obs is (`KSCHED_OBS=0` turns the
    whole subsystem off, solver interior included), which keeps the
    traced program identical to the pre-telemetry baseline."""
    if override is not None:
        return max(0, int(override))
    from .metrics import enabled as obs_enabled

    return SOLTEL_DEFAULT_CAP if (_enabled and obs_enabled()) else 0


# ---------------------------------------------------------------------------
# device-side helpers (torch, on the ring's device)
# ---------------------------------------------------------------------------
#
# One row layout and one ring write for every plain backend; the counter
# SEMANTICS per column live in each solver. Kernel B3 writes its ring
# itself (ops/csrc/mcmf.cu). torch is imported lazily: obs stays
# importable host-only.


def device_ring(cap: int, device):
    """A zeroed int32 [cap, SOLTEL_WIDTH] ring on `device`."""
    import torch

    return torch.zeros((cap, SOLTEL_WIDTH), dtype=torch.int32, device=device)


def device_row(eps, active, excess, pushed, relabels, saturated, work, device):
    """One SOLTEL_COLS telemetry row (col 7 pad) on `device`, from int32
    scalar tensors there or Python ints. A Python int is added to a
    zero on the device (a kernel argument), never copied: no host sync."""
    import torch

    zero = torch.zeros((), dtype=torch.int32, device=device)
    vals = (eps, active, excess, pushed, relabels, saturated, work, 0)
    return torch.stack([zero + v for v in vals])


def device_ring_write(tel, steps: int, row) -> None:
    """Write `row` at ring slot `steps % cap`, in place (the plain
    solves count supersteps on the host, so the slot is a Python int)."""
    tel[steps % tel.shape[0]] = row


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@dataclass
class SolveTelemetry:
    """One solve's decoded telemetry, rows in superstep order."""

    backend: str
    steps: int  # supersteps the solve executed
    budget: int  # the superstep cap the solve ran under
    cap: int  # ring capacity (rows the buffer could hold)
    truncated: bool  # steps > cap: only the final `cap` rows survive
    start_step: int  # superstep index of rows[0]
    rows: np.ndarray  # int32 [kept, SOLTEL_WIDTH]
    converged: bool = True
    nodes: int = 0
    arcs: int = 0

    def col(self, name: str) -> np.ndarray:
        return self.rows[:, SOLTEL_COLS.index(name)]

    def phases(self) -> List[Dict[str, int]]:
        """Per-eps-phase superstep counts, from eps transitions in the
        kept rows: [{"eps": e, "supersteps": k}, ...] oldest first.
        Vectorized — publish() runs this per solve on the hot path."""
        eps = self.col("eps")
        if not len(eps):
            return []
        starts = np.flatnonzero(np.diff(eps) != 0) + 1
        bounds = np.concatenate([[0], starts, [len(eps)]])
        return [
            {"eps": int(eps[a]), "supersteps": int(b - a)}
            for a, b in zip(bounds[:-1], bounds[1:])
        ]

    def tail(self, k: int = SOLTEL_TAIL) -> List[List[int]]:
        """The final k kept rows, JSON-able (for stall events/dumps)."""
        return [[int(v) for v in row] for row in self.rows[-k:]]

    def to_dict(self) -> dict:
        """JSON-able form; ksched_tpu_torch/tools/obs_report.py renders
        it as a convergence table (the `solver_telemetry` dump kind)."""
        return {
            "backend": self.backend,
            "steps": self.steps,
            "budget": self.budget,
            "cap": self.cap,
            "truncated": self.truncated,
            "start_step": self.start_step,
            "converged": self.converged,
            "nodes": self.nodes,
            "arcs": self.arcs,
            "cols": list(SOLTEL_COLS),
            "rows": [[int(v) for v in row] for row in self.rows],
        }


def decode(
    buf,
    steps: int,
    cap: int,
    backend: str,
    budget: int,
    converged: bool = True,
    nodes: int = 0,
    arcs: int = 0,
) -> SolveTelemetry:
    """Unroll a device telemetry ring into superstep order.

    `buf` is the raw `[cap, SOLTEL_WIDTH]` device/host array; `steps`
    the solve's executed superstep count. Rows past `steps` were never
    written (zeros); when `steps > cap` the ring wrapped and the kept
    rows are supersteps `steps - cap .. steps - 1` — truncation is
    REPORTED, never silent. `buf` may be a tensor on any device (one
    copy to the host)."""
    if hasattr(buf, "cpu"):
        buf = buf.cpu().numpy()
    data = np.asarray(buf)
    if data.ndim != 2 or data.shape[1] != SOLTEL_WIDTH or data.shape[0] != cap:
        raise ValueError(
            f"telemetry buffer shape {data.shape} != ({cap}, {SOLTEL_WIDTH})"
        )
    steps = int(steps)
    if steps <= cap:
        rows = data[:steps]
        start = 0
    else:
        idx = np.arange(steps - cap, steps) % cap
        rows = data[idx]
        start = steps - cap
    return SolveTelemetry(
        backend=backend,
        steps=steps,
        budget=int(budget),
        cap=int(cap),
        truncated=steps > cap,
        start_step=int(start),
        rows=np.array(rows, dtype=np.int32, copy=True),
        converged=bool(converged),
        nodes=int(nodes),
        arcs=int(arcs),
    )


# ---------------------------------------------------------------------------
# stall / divergence detection
# ---------------------------------------------------------------------------


def detect_stall(
    tel: SolveTelemetry, window: int = SOLTEL_STALL_WINDOW
) -> Optional[dict]:
    """Structured stall reason for a solve's telemetry, or None.

    Rules, most-specific first:
    - `superstep_budget_exhausted`: the solve burned its whole budget
      without converging (a bare timeout, now with interior evidence);
    - `excess_plateau`: `window` consecutive supersteps without the
      total positive excess decreasing — the discharge is circulating,
      not draining (the warm-start tail pathology);
    - `eps_plateau`: eps pinned at one value for 2x the window with
      active nodes throughout — a phase that cannot drain;
    - `superstep_cap_proximity`: a converged solve that consumed >=90%
      of its budget — the next churn delta may not converge at all.
    """
    if tel.steps == 0:
        return None
    excess = tel.col("excess")
    eps = tel.col("eps")
    active = tel.col("active")
    base = {
        "backend": tel.backend,
        "supersteps": tel.steps,
        "budget": tel.budget,
        "converged": tel.converged,
        "eps": int(eps[-1]) if len(eps) else 0,
        "excess": int(excess[-1]) if len(excess) else 0,
        "active": int(active[-1]) if len(active) else 0,
    }
    plateau = None
    if len(excess) >= window:
        w = excess[-window:]
        # the window must sit WITHIN one eps phase: next_phase's
        # saturate legitimately re-raises total excess at a phase
        # boundary, which is progress, not circulation — only a
        # fixed-eps window without excess decrease is the tail
        # pathology
        if (
            (w > 0).all()
            and int(w.min()) >= int(w[0])
            and (eps[-window:] == eps[-1]).all()
        ):
            plateau = {
                "kind": "excess_plateau",
                "window": window,
                "detail": (
                    f"{window} supersteps without excess decrease "
                    f"({int(w[0])} -> {int(w[-1])} units at eps {base['eps']})"
                ),
                **base,
            }
    if not tel.converged:
        if plateau is not None:
            return plateau
        if len(eps) >= 2 * window and (eps[-2 * window:] == eps[-1]).all() and (
            active[-2 * window:] > 0
        ).all():
            return {
                "kind": "eps_plateau",
                "window": 2 * window,
                "detail": (
                    f"eps pinned at {base['eps']} for {2 * window}+ "
                    "supersteps with active nodes"
                ),
                **base,
            }
        return {
            "kind": "superstep_budget_exhausted",
            "detail": (
                f"{tel.steps} supersteps consumed the {tel.budget} budget "
                "without convergence"
            ),
            **base,
        }
    if plateau is not None:
        return plateau
    if tel.budget > 0 and tel.steps >= max(1, (9 * tel.budget) // 10):
        return {
            "kind": "superstep_cap_proximity",
            "detail": (
                f"converged at {tel.steps}/{tel.budget} supersteps "
                "(>=90% of budget)"
            ),
            **base,
        }
    return None


class SolverStallError(RuntimeError):
    """Non-convergence with its interior evidence attached: `.reason`
    is `detect_stall`'s structured dict, `.telemetry` the decoded
    buffer of the failed attempt. A RuntimeError subclass, so the
    degradation ladder absorbs it like the bare timeout it replaces."""

    def __init__(
        self,
        message: str,
        reason: Optional[dict] = None,
        telemetry: Optional[SolveTelemetry] = None,
    ) -> None:
        super().__init__(message)
        self.reason = reason
        self.telemetry = telemetry


# ---------------------------------------------------------------------------
# stall-event ring (what flight dumps embed)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_stalls: deque = deque(maxlen=32)
_last_tel: Optional[SolveTelemetry] = None
#: ambient stall attribution scope (thread-local): the multi-tenant
#: loop enters `stall_scope(tenant_id)` around each tenant's dispatch/
#: complete phases, so every stall event deposited while a tenant's
#: lane is being driven carries that tenant — tenant-scoped flight
#: recorders filter their dumps' solver_stalls section on it
_scope_tls = threading.local()


class stall_scope:
    """``with stall_scope("t3"):`` — tag stall events deposited in the
    block (this thread) with a tenant/scope discriminator. Reentrant;
    the innermost scope wins."""

    def __init__(self, scope: Optional[str]) -> None:
        self.scope = scope

    def __enter__(self) -> "stall_scope":
        stack = getattr(_scope_tls, "stack", None)
        if stack is None:
            stack = _scope_tls.stack = []
        stack.append(self.scope)
        return self

    def __exit__(self, *exc) -> None:
        _scope_tls.stack.pop()


def current_stall_scope() -> Optional[str]:
    stack = getattr(_scope_tls, "stack", None)
    return stack[-1] if stack else None


def note_stall(reason: dict, tel: Optional[SolveTelemetry] = None) -> dict:
    """Deposit a structured stall event (with the final SOLTEL_TAIL
    supersteps of telemetry) into the bounded ring the flight recorder
    dumps, and count it on the registry."""
    if tel is None:
        tel = _last_tel
    event = dict(reason)
    event.setdefault("ts", time.time())
    scope = current_stall_scope()
    if scope is not None and "tenant" not in event:
        event["tenant"] = scope
    if tel is not None:
        event["telemetry_cols"] = list(SOLTEL_COLS)
        event["telemetry_tail"] = tel.tail()
        event["telemetry_start_step"] = max(
            tel.start_step, tel.steps - len(event["telemetry_tail"])
        )
        event["telemetry_truncated"] = tel.truncated
    with _lock:
        _stalls.append(event)
    get_registry().counter(
        "ksched_solver_stalls_total",
        "solver stall/divergence events by detector rule",
        labelnames=("kind",),
    ).labels(kind=str(reason.get("kind", "unknown"))).inc()
    return event


def warm_price_war(
    backend: str,
    supersteps: int,
    budget: int,
    escaped_to: str = "fresh_restart",
    tel: Optional[SolveTelemetry] = None,
) -> dict:
    """Structured price-war event: a WARM attempt burned its superstep
    budget without converging and the solver is escaping to a restart.
    Deposited on the stall ring (so every flight dump carries it, with
    the attempt's telemetry tail when available) — flight dumps can now
    distinguish a warm-start price war (eps pinned at 1, supersteps >=
    the warm budget, solved instantly by a fresh restart) from genuine
    non-convergence. Since the dirty-frontier refit landed these should
    be RARE; a recurring stream of them means the carried prices are
    being invalidated faster than the refit can repair them."""
    reason = {
        "kind": "warm_price_war",
        "backend": backend,
        "supersteps": int(supersteps),
        "budget": int(budget),
        "converged": False,
        "eps": int(tel.col("eps")[-1]) if tel is not None and len(tel.rows) else 1,
        "excess": int(tel.col("excess")[-1]) if tel is not None and len(tel.rows) else 0,
        "active": int(tel.col("active")[-1]) if tel is not None and len(tel.rows) else 0,
        "detail": (
            f"warm attempt burned {int(supersteps)}/{int(budget)} supersteps "
            f"without converging (price war); escaping to {escaped_to}"
        ),
    }
    return note_stall(reason, tel)


def recent_stalls() -> List[dict]:
    with _lock:
        return list(_stalls)


def reset_stalls() -> None:
    global _last_tel
    with _lock:
        _stalls.clear()
    _last_tel = None


def failure_reason(rung: str, err: BaseException) -> dict:
    """The degradation ladder's structured reason for a failed rung:
    the stall detector's verdict when the error carries telemetry
    (a genuine non-convergence), otherwise a classification of the
    error itself — with the most recent solve telemetry's tail either
    way, so a flight dump always shows the interior state leading up
    to the failure."""
    reason: dict = {
        "rung": rung,
        "error": f"{type(err).__name__}: {err}",
    }
    stall = getattr(err, "reason", None)
    if isinstance(stall, dict):
        reason.update(stall)
    elif isinstance(err, OverflowError):
        reason["kind"] = "overflow"
    elif "chaos" in str(err):
        reason["kind"] = "injected_fault"
    elif isinstance(err, ValueError):
        reason["kind"] = "rejected_input"
    else:
        reason["kind"] = "backend_error"
    return reason


# ---------------------------------------------------------------------------
# publication (registry + synthesized child spans)
# ---------------------------------------------------------------------------


def publish(tel: Optional[SolveTelemetry], sp=None) -> Optional[dict]:
    """Publish one solve's telemetry: registry histograms/counters,
    per-superstep child spans under the open `backend_solve` span (when
    a tracer is recording), and the stall detector. Returns the stall
    event when one was noted. Called from `solver/base.solve_traced`
    (and the bulk scheduler's layered path) right after the solve —
    entirely host-side, after the device work is already fetched."""
    global _last_tel
    if tel is None or tel.steps == 0:
        return None
    _last_tel = tel
    reg = get_registry()
    reg.histogram(
        "ksched_solve_supersteps",
        "supersteps per solve, from solver-interior telemetry",
        labelnames=("backend",),
        buckets=COUNT_BUCKETS,
    ).labels(backend=tel.backend).observe(tel.steps)
    phase_hist = reg.histogram(
        "ksched_solve_phase_supersteps",
        "supersteps per cost-scaling eps phase",
        labelnames=("backend",),
        buckets=COUNT_BUCKETS,
    ).labels(backend=tel.backend)
    for phase in tel.phases():
        phase_hist.observe(phase["supersteps"])
    pushed = reg.counter(
        "ksched_solve_pushes_total",
        "flow units moved by solver supersteps",
        labelnames=("backend",),
    ).labels(backend=tel.backend)
    relabeled = reg.counter(
        "ksched_solve_relabels_total",
        "node relabels executed by solver supersteps",
        labelnames=("backend",),
    ).labels(backend=tel.backend)
    pushed.inc(int(tel.col("pushed").astype(np.int64).sum()))  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
    relabeled.inc(int(tel.col("relabels").astype(np.int64).sum()))  # kschedlint: disable=dtype64,int32-reduce -- int64 sums on the host
    if tel.truncated:
        reg.counter(
            "ksched_solve_telemetry_truncated_total",
            "solves whose telemetry ring wrapped (steps > cap)",
            labelnames=("backend",),
        ).labels(backend=tel.backend).inc()
    _synthesize_spans(tel, sp)
    stall = detect_stall(tel)
    if stall is not None:
        return note_stall(stall, tel)
    return None


def _synthesize_spans(tel: SolveTelemetry, sp) -> None:
    """Per-superstep child spans under the (still-open) backend_solve
    span. The device gives counts, not wall times, so the parent span's
    elapsed wall is apportioned across kept supersteps proportionally
    to their work column — the trace shows the convergence SHAPE (which
    supersteps were heavy, where eps phases turned over), which is the
    thing a flat superstep count cannot."""
    from .spans import active_tracer

    tracer = active_tracer()
    if tracer is None or sp is None or not getattr(sp, "sid", 0):
        return
    t0 = sp.t0_s
    t1 = time.perf_counter()
    span_s = max(t1 - t0, 1e-9)
    work = tel.col("work").astype(np.float64) + tel.col("pushed") + 1.0  # kschedlint: host-only (host decode of the ring)
    frac = work / work.sum()  # kschedlint: disable=int32-reduce -- a host numpy sum
    starts = t0 + np.concatenate([[0.0], np.cumsum(frac)[:-1]]) * span_s
    durs = frac * span_s
    for i, row in enumerate(tel.rows):
        tracer.record_event(
            "superstep",
            t0_s=float(starts[i]),
            dur_s=float(durs[i]),
            args={
                "step": tel.start_step + i,
                "eps": int(row[0]),
                "active": int(row[1]),
                "excess": int(row[2]),
                "pushed": int(row[3]),
                "relabels": int(row[4]),
                "saturated": int(row[5]),
                "work": int(row[6]),
                "parent_sid": sp.sid,
                "parent": sp.name,
            },
        )


def publish_round_supersteps(supersteps, backend: str) -> None:
    """Per-round superstep counts from a device-fused path (the
    DeviceBulkCluster rounds, trace replay) onto the registry — the
    interior of those solves stays on the device, but the per-round
    superstep series is solver telemetry too; a bench publishes it
    after its clock stops. Takes a sequence, an array or a tensor."""
    if hasattr(supersteps, "cpu"):
        supersteps = supersteps.cpu().numpy()
    ss = np.asarray(supersteps).reshape(-1)
    if ss.size == 0:
        return
    hist = get_registry().histogram(
        "ksched_solve_supersteps",
        "supersteps per solve, from solver-interior telemetry",
        labelnames=("backend",),
        buckets=COUNT_BUCKETS,
    ).labels(backend=backend)
    for v in ss:
        hist.observe(int(v))
