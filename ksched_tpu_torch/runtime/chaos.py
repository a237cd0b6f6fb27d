"""Seeded, deterministic fault injection (the chaos harness).

Firmament and Borg both stress that cluster schedulers live or die by
how they ride out control-plane blips, silent machines, and solver
failures — and the only way to *test* that is to inject those faults on
a reproducible schedule. Everything here is driven by independent
`numpy` RNG streams spawned from one seed, so the same seed produces
the same fault schedule, fault for fault, across runs:

- `ChaosPolicy` — the knob set (probabilities, durations, kinds);
- `FaultInjector` — draws the schedule and counts every injected fault
  (the soak asserts these totals against the per-round `RoundRecord`
  counters, so no fault can go unobserved);
- `ChaosClusterAPI` — wraps any `ClusterAPI` with control-plane faults
  that stay deterministic under a single-threaded driver: API outages
  (batches suppressed, events held back), dropped binding POSTs (the
  pod re-surfaces, as a real watch would re-list it);
- HTTP-shaped faults (`http_fault`) for `cluster/fake_apiserver.py`'s
  hermetic fault hook: 5xx, hangs, latency spikes over real sockets.

Solver faults (forced non-convergence, backend exceptions, NaN'd cost
inputs) are consumed by `runtime/degrade.py`'s degradation ladder via
`solver_fault(rung)`.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cluster.api import Binding, ClusterAPI, NodeEvent, PodEvent
from ..obs.metrics import get_registry

#: solver fault kinds the injector can schedule (see degrade.py)
SOLVER_FAULT_KINDS = ("nonconverge", "exception", "nan_cost")


class ChaosBackendError(RuntimeError):
    """The injected stand-in for an arbitrary backend exception."""


@dataclass(frozen=True)
class ChaosPolicy:
    """Fault-schedule knobs. All probabilities default to 0 (inert).

    Per-round draws: `api_outage_prob` starts a control-plane outage
    lasting `api_outage_rounds` (min, max) rounds; `machine_flap_prob`
    (per machine per round) silences a machine's heartbeats for
    `machine_flap_rounds` rounds; `solver_fault_prob` faults the
    configured backend rung with a kind from `solver_fault_kinds`, and
    `solver_total_outage_prob` faults *every* rung (forcing a NOOP
    round). Per-event draws: `binding_drop_prob` on each binding POST;
    `http_error_prob` / `http_hang_prob` / `http_latency_prob` on each
    HTTP request through the fake API server's fault hook.
    """

    seed: int = 0
    # control-plane outages (whole rounds of empty batches)
    api_outage_prob: float = 0.0
    api_outage_rounds: Tuple[int, int] = (1, 3)
    # per-request HTTP faults (fake_apiserver hook)
    http_error_prob: float = 0.0
    http_hang_prob: float = 0.0
    http_latency_prob: float = 0.0
    http_latency_s: Tuple[float, float] = (0.02, 0.1)
    http_hang_s: float = 1.0
    # binding-POST drops
    binding_drop_prob: float = 0.0
    # machine heartbeat flaps
    machine_flap_prob: float = 0.0
    machine_flap_rounds: Tuple[int, int] = (2, 5)
    # solver faults
    solver_fault_prob: float = 0.0
    solver_fault_kinds: Tuple[str, ...] = SOLVER_FAULT_KINDS
    solver_total_outage_prob: float = 0.0
    # state-corruption faults (runtime/integrity.py): a per-solve draw
    # flips one bit of one persistent device buffer via a seeded poison
    # scatter — the fault class the fingerprint audit must catch the
    # round it happens
    device_corrupt_prob: float = 0.0
    device_corrupt_arrays: Tuple[str, ...] = (
        "excess", "src", "dst", "cap", "cost", "p_sign",
    )
    # checkpoint-corruption faults: at each kill-and-restore the soak
    # draws one of wal_drop / wal_dup / wal_torn (dropped WAL record,
    # duplicated record, torn checkpoint write) against the warm
    # manifest; restore must DETECT it and fall back to cold replay
    wal_corrupt_prob: float = 0.0
    wal_corrupt_kinds: Tuple[str, ...] = ("wal_drop", "wal_dup", "wal_torn")

    def __post_init__(self) -> None:
        bad = [k for k in self.solver_fault_kinds if k not in SOLVER_FAULT_KINDS]
        if bad:
            raise ValueError(
                f"unknown solver fault kinds {bad}; want a subset of "
                f"{SOLVER_FAULT_KINDS}"
            )


class FaultInjector:
    """Draws the fault schedule from independent per-domain RNG streams
    and counts every fault actually injected.

    Separate streams per fault domain (outages, bindings, solver,
    flaps, HTTP) keep the schedule deterministic even when one domain's
    consumption rate varies — e.g. HTTP request counts depend on
    wall-clock poll timing, but that cannot perturb the solver-fault or
    flap schedule. `begin_round` advances round-granular draws;
    per-event draws happen at the injection site. `quiesce()` stops all
    new faults (the soak's cooldown, so dropped bindings settle before
    final-state comparison).
    """

    def __init__(self, policy: ChaosPolicy) -> None:
        self.policy = policy
        # streams 0-4 predate the corruption domains; spawn keys are
        # sequential, so appending streams keeps every pre-existing
        # fixed-seed fault schedule bit-identical
        streams = np.random.SeedSequence(policy.seed).spawn(7)
        self._rng_outage = np.random.default_rng(streams[0])
        self._rng_bind = np.random.default_rng(streams[1])
        self._rng_solver = np.random.default_rng(streams[2])
        self._rng_flap = np.random.default_rng(streams[3])
        self._rng_http = np.random.default_rng(streams[4])
        self._rng_corrupt = np.random.default_rng(streams[5])
        self._rng_wal = np.random.default_rng(streams[6])
        self.counters: Counter = Counter()
        # live twin of `counters` on the obs registry: the obs smoke
        # reconciles this against the tracer's per-round attribution
        # (handles resolve at construction time; scoped_registry works)
        self._m_injected = get_registry().counter(
            "ksched_chaos_injected_total",
            "faults injected by the chaos harness, by kind",
            labelnames=("kind",),
        )
        self.round_index = -1
        self._outage_rounds_left = 0
        #: this round's solver plan: {} | {rung 0: kind} | {all rungs: kind}
        self._solver_plan: Dict[int, str] = {}
        self._solver_plan_all = False
        self._flaps: Dict[int, int] = {}  # machine key -> silent rounds left
        self._quiesced = False

    def _count(self, kind: str, n: int = 1) -> None:
        """Count one injected fault, in both accounting surfaces: the
        deterministic Counter (soak determinism asserts compare it
        bit-for-bit) and the live metrics registry."""
        self.counters[kind] += n
        self._m_injected.labels(kind=kind).inc(n)

    # -- lifecycle ---------------------------------------------------------

    def quiesce(self) -> None:
        """Stop injecting: active outages/flaps end, no new draws fire."""
        self._quiesced = True
        self._outage_rounds_left = 0
        self._solver_plan = {}
        self._flaps.clear()

    def begin_round(self, round_index: int) -> None:
        """Advance round-granular schedules (outage windows, the solver
        fault plan). Call once per scheduler round, before polling."""
        self.round_index = round_index
        if self._outage_rounds_left > 0:
            self._outage_rounds_left -= 1
        self._solver_plan = {}
        self._solver_plan_all = False
        if self._quiesced:
            return
        p = self.policy
        if (
            self._outage_rounds_left == 0
            and p.api_outage_prob > 0
            and self._rng_outage.random() < p.api_outage_prob
        ):
            lo, hi = p.api_outage_rounds
            self._outage_rounds_left = int(self._rng_outage.integers(lo, hi + 1))
        if p.solver_total_outage_prob > 0 and (
            self._rng_solver.random() < p.solver_total_outage_prob
        ):
            kind = str(self._rng_solver.choice(p.solver_fault_kinds))
            self._solver_plan_all = True
            self._solver_plan = {0: kind}
        elif p.solver_fault_prob > 0 and (
            self._rng_solver.random() < p.solver_fault_prob
        ):
            self._solver_plan = {0: str(self._rng_solver.choice(p.solver_fault_kinds))}

    # -- control-plane faults ---------------------------------------------

    def outage_active(self) -> bool:
        return self._outage_rounds_left > 0

    def note_outage_round(self) -> None:
        """Count one suppressed batch poll (called by ChaosClusterAPI)."""
        self._count("api_outage_round")

    def drop_binding(self) -> bool:
        if self._quiesced or self.policy.binding_drop_prob <= 0:
            return False
        if self._rng_bind.random() < self.policy.binding_drop_prob:
            self._count("binding_drop")
            return True
        return False

    # -- machine heartbeat flaps ------------------------------------------

    def machine_silent(self, machine_key: int) -> bool:
        """Whether this machine's heartbeat is suppressed this round.
        Call once per machine per round (the draw advances per call)."""
        left = self._flaps.get(machine_key, 0)
        if left > 0:
            self._flaps[machine_key] = left - 1
            self._count("machine_flap_round")
            return True
        if self._quiesced or self.policy.machine_flap_prob <= 0:
            return False
        if self._rng_flap.random() < self.policy.machine_flap_prob:
            lo, hi = self.policy.machine_flap_rounds
            self._flaps[machine_key] = int(self._rng_flap.integers(lo, hi + 1)) - 1
            self._count("machine_flap")
            self._count("machine_flap_round")
            return True
        return False

    # -- solver faults (consumed by the degradation ladder) ---------------

    def solver_fault(self, rung_index: int) -> Optional[str]:
        """The fault kind scheduled for this rung this round, or None.
        Counted at injection time, so un-consulted plans (e.g. rounds
        with no solve) never inflate the totals."""
        if self._solver_plan_all:
            kind = self._solver_plan.get(0)
        else:
            kind = self._solver_plan.get(rung_index)
        if kind is not None:
            self._count(f"solver_{kind}")
        return kind

    # -- state-corruption faults (runtime/integrity.py) -------------------

    def device_corruption(
        self, n_cap: int, m_cap: int, available=None
    ) -> Optional[dict]:
        """One per-solve device-buffer bit-flip draw: None, or
        {"array", "index", "bit"} for integrity.apply_device_corruption.
        Node-space arrays index within n_cap, arc/plan-space within
        m_cap (the applier re-mods against the live buffer extent, so
        plan tensors sized 2*m_cap stay in range). ``available`` narrows
        the targets to buffers that exist right now (the plan mirror is
        built lazily) — availability is state-driven and deterministic,
        so the schedule stays reproducible. Counted as
        `device_bit_flip` at injection time; a draw with no live target
        injects (and counts) nothing."""
        if self._quiesced or self.policy.device_corrupt_prob <= 0:
            return None
        if self._rng_corrupt.random() >= self.policy.device_corrupt_prob:
            return None
        arrays = tuple(
            a for a in self.policy.device_corrupt_arrays
            if available is None or a in available
        )
        if not arrays:
            return None
        name = str(arrays[int(self._rng_corrupt.integers(0, len(arrays)))])
        extent = n_cap if name == "excess" else m_cap
        spec = {
            "array": name,
            "index": int(self._rng_corrupt.integers(0, max(extent, 1))),
            "bit": int(self._rng_corrupt.integers(0, 31)),
        }
        self._count("device_bit_flip")
        return spec

    def checkpoint_corruption(self) -> Optional[Tuple[str, int]]:
        """One per-checkpoint WAL corruption draw: None, or
        (kind, seed) where kind is wal_drop/wal_dup/wal_torn and seed
        feeds integrity.corrupt_wal_file's deterministic byte choice.
        Counted by kind at injection time."""
        if self._quiesced or self.policy.wal_corrupt_prob <= 0:
            return None
        if self._rng_wal.random() >= self.policy.wal_corrupt_prob:
            return None
        kinds = self.policy.wal_corrupt_kinds
        kind = str(kinds[int(self._rng_wal.integers(0, len(kinds)))])
        self._count(kind)
        return kind, int(self._rng_wal.integers(0, 1 << 31))

    # -- HTTP faults (the fake API server hook) ---------------------------

    def http_fault(self, route: str) -> Optional[dict]:
        """Per-request fault draw for the hermetic API server. Returns
        None or {"kind": "error"|"hang"|"latency", ...}. The side-door
        /_test routes are never faulted (the test driver must always be
        able to steer)."""
        if self._quiesced or route.startswith("_test"):
            return None
        p = self.policy
        r = self._rng_http.random()
        if r < p.http_error_prob:
            self._count("http_error")
            return {"kind": "error", "code": 503}
        r -= p.http_error_prob
        if r < p.http_hang_prob:
            self._count("http_hang")
            return {"kind": "hang", "seconds": p.http_hang_s}
        r -= p.http_hang_prob
        if r < p.http_latency_prob:
            lo, hi = p.http_latency_s
            self._count("http_latency")
            return {
                "kind": "latency",
                "seconds": float(lo + (hi - lo) * self._rng_http.random()),
            }
        return None

    # -- accounting --------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)


def delta_counters(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """after - before, keeping only keys that moved (for RoundRecord).
    Counters are monotone, so Counter subtraction (positive-only) is it."""
    return dict(Counter(after) - Counter(before))


def poison_costs(problem):
    """A copy of the FlowProblem with NaN'd cost inputs — the chaos
    stand-in for a cost model emitting garbage. Backends must *reject*
    this (non-finite validation) rather than solve on wrapped-int
    nonsense; every backend shares solver/base.check_finite_costs."""
    cost = np.asarray(problem.cost, dtype=np.float64).copy()
    if len(cost):
        cost[len(cost) // 2] = np.nan
    return dataclasses.replace(problem, cost=cost)


class ChaosClusterAPI(ClusterAPI):
    """A fault-injecting decorator over any ClusterAPI.

    Deterministic under a single-threaded driver (the chaos soak):
    during an injected API outage, batch polls return empty without
    draining — queued events are delivered when the outage ends,
    exactly as informers re-list after an API-server blip. A dropped
    binding POST re-surfaces its pod on the next batch (the pending
    listing would still show it), so the service's re-deliver/re-post
    machinery is exercised end to end.
    """

    def __init__(self, inner: ClusterAPI, injector: FaultInjector) -> None:
        self.inner = inner
        self.injector = injector
        self._last_event: Dict[str, PodEvent] = {}
        self._resurfaced: List[PodEvent] = []
        self.counters: Counter = Counter()

    # -- producer passthrough ---------------------------------------------

    def submit_pod(self, pod: PodEvent) -> None:
        self.inner.submit_pod(pod)

    def submit_node(self, node: NodeEvent) -> None:
        self.inner.submit_node(node)

    # -- consumer side -----------------------------------------------------

    def get_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        # Blocking contract: "[] only on close" — an injected outage
        # must NOT surface as an empty batch here, or a blocking
        # consumer (e.g. the --one-shot main path) would misread a
        # 1-3 round outage as shutdown. Outage suppression lives in
        # poll_pod_batch, the hardened loop's closed-vs-outage path.
        if self._resurfaced:
            # Already-deliverable pods must not wait behind the inner
            # blocking call (which only wakes on a brand-new pod or
            # close — starving them, and on close dropping them).
            out, self._resurfaced = self._resurfaced, []
            return out
        return self._with_resurfaced(self.inner.get_pod_batch(timeout_s))

    def poll_pod_batch(self, timeout_s: float) -> List[PodEvent]:
        if self.injector.outage_active():
            self.injector.note_outage_round()
            return []
        return self._with_resurfaced(self.inner.poll_pod_batch(timeout_s))

    def _with_resurfaced(self, batch: List[PodEvent]) -> List[PodEvent]:
        for pod in batch:
            self._last_event[pod.pod_id] = pod
        if self._resurfaced:
            batch = self._resurfaced + batch
            self._resurfaced = []
        return batch

    def get_node_batch(self, timeout_s: float) -> List[NodeEvent]:
        return self.inner.get_node_batch(timeout_s)

    def assign_bindings(self, bindings: List[Binding]) -> None:
        kept = []
        for b in bindings:
            if self.injector.drop_binding():
                # the POST "failed": the pod is still pending server-side
                # and re-enters the next batch; the service must re-post
                event = self._last_event.get(b.pod_id, PodEvent(pod_id=b.pod_id))
                self._resurfaced.append(event)
                self.counters["binding_reposts_pending"] += 1
            else:
                kept.append(b)
        if kept:
            self.inner.assign_bindings(kept)

    def close(self) -> None:
        self.inner.close()

    def is_closed(self) -> bool:
        return self.inner.is_closed()

    def bindings(self):
        return self.inner.bindings()

    def stats(self) -> Dict[str, int]:
        return dict(self.counters)
