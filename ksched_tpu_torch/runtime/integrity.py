"""State integrity: device-state fingerprints, divergence repair, WAL.

Placements depend on a long-lived chain of in-place scatters into
persistent device tensors (graph/device_export.delta_apply,
graph/slot_plan.plan_apply) that nothing audits after the first upload.
This module closes that gap with three pieces:

- **Fingerprints** — order-independent weighted checksums of every
  persistent device tensor (problem arrays, slot-plan tensors, the
  carried warm flow), computed on the tensor's own device and compared
  against bit-exact host twins derived from the journal-maintained host
  arrays (the source of truth). The weights are odd, so any single-bit
  flip of any element changes the checksum: a wrong scatter, a stale
  plan row or a bit-flipped tensor is caught the round it happens.
  The device checksum is plain torch: int32 arithmetic that wraps mod
  2**32, carried in int64 and masked (`_device_fp1`).

- **Divergence repair ladder** — `StateAuditor.repair` escalates:
  re-scatter exactly the diverged rows (through `delta_apply`) → full
  problem and plan tensor re-upload; the caller (solver/placement.py)
  holds the final `full_build` rung (which also rebuilds the plan
  layout and resets solver warm state), and the degradation ladder's
  NOOP round backstops even that. Both auditor rungs restore the exact
  pre-corruption tensors, so a repaired round's placements are
  bit-identical to a clean-state solve. Every audit, divergence and
  repair is counted (`ksched_state_audits_total{result}`,
  `ksched_state_repairs_total{rung}`) and every divergence deposits a
  structured `state_divergence` event on the soltel stall ring that
  flight dumps embed.

- **WAL record framing** — checkpoint manifests (runtime/checkpoint.py
  `save_warm_manifest`) are written as a sequence of seq-numbered,
  CRC-framed records. `read_records` detects dropped records (seq
  gap), duplicated records (seq dup), torn writes (truncation) and bit
  rot (CRC) as distinct `WALCorrupted` kinds — the corruption fault
  classes `runtime/chaos.py` injects (`corrupt_wal_file`) and
  `SchedulerService.restore` contains by falling back to cold event
  replay. The byte format is ksched_tpu's, so either package reads the
  other's manifests' framing.

Port of ksched_tpu/runtime/integrity.py.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.metrics import get_registry

#: fingerprint weight recurrence constants (Knuth multiplicative hash):
#: w[i] = (i * MUL + ADD) mod 2**32, forced odd
_FP_MUL = 2654435761
_FP_ADD = 0x9E3779B9
_MASK32 = 0xFFFFFFFF

#: problem-tensor fingerprint order (DeviceResidentState.d_*)
FP_STATE_ARRAYS = ("excess", "src", "dst", "cap", "cost")
#: plan-tensor fingerprint order (DeviceResidentState.d_p_* mirror)
FP_PLAN_ARRAYS = (
    "p_arc", "p_sign", "p_src", "p_dst", "inv_order",
    "seg_start", "is_start", "node_first", "node_last", "node_nonempty",
)

#: mismatching indices carried on an IntegrityError / divergence event
DIFF_BOUND = 8


class IntegrityError(AssertionError):
    """Structured state-integrity failure: which array diverged, and a
    BOUNDED diff summary (first-`DIFF_BOUND` mismatching indices with
    expected vs found values) instead of a bare assert. An
    AssertionError subclass so bare-assert consumers keep catching
    it."""

    def __init__(
        self,
        message: str,
        array: str = "",
        indices: Optional[Sequence[int]] = None,
        expected: Optional[Sequence[int]] = None,
        found: Optional[Sequence[int]] = None,
    ) -> None:
        super().__init__(message)
        self.array = array
        self.indices = list(indices or [])[:DIFF_BOUND]
        self.expected = list(expected or [])[:DIFF_BOUND]
        self.found = list(found or [])[:DIFF_BOUND]

    def to_dict(self) -> dict:
        return {
            "array": self.array,
            "indices": [int(i) for i in self.indices],
            "expected": [int(v) for v in self.expected],
            "found": [int(v) for v in self.found],
            "detail": str(self),
        }


def bounded_diff(name: str, found: np.ndarray, expected: np.ndarray) -> IntegrityError:
    """An IntegrityError for one diverged array, carrying the first
    DIFF_BOUND mismatching indices."""
    got = np.asarray(found)
    want = np.asarray(expected)
    if got.shape != want.shape:
        return IntegrityError(
            f"{name}: shape {got.shape} != expected {want.shape}", array=name
        )
    bad = np.nonzero(got != want)[0]
    head = bad[:DIFF_BOUND]
    return IntegrityError(
        f"{name} diverged at {len(bad)} row(s); first {len(head)}: "
        f"idx={head.tolist()} found={got[head].tolist()} "
        f"expected={want[head].tolist()}",
        array=name,
        indices=head.tolist(),
        expected=want[head].tolist(),
        found=got[head].tolist(),
    )


# ---------------------------------------------------------------------------
# fingerprints: device checksums + bit-exact host twins
# ---------------------------------------------------------------------------


_WEIGHTS: Dict[int, np.ndarray] = {}


def host_weights(n: int) -> np.ndarray:
    """uint32 weight vector w[i] = i*MUL + ADD (mod 2**32), forced odd,
    so a single-bit flip of any element always moves the weighted
    sum."""
    cached = _WEIGHTS.get(n)
    if cached is not None:
        return cached
    i = np.arange(n, dtype=np.uint64)
    w = (i * np.uint64(_FP_MUL) + np.uint64(_FP_ADD)) & _MASK32
    # forced odd: the recurrence alone yields even weights at odd i,
    # and an even weight with k trailing zero bits makes flips of the
    # top k bits invisible mod 2**32. With w odd, w * 2**b != 0 mod
    # 2**32 for every b < 32.
    out = (w | np.uint64(1)).astype(np.uint32)
    if len(_WEIGHTS) > 64:
        _WEIGHTS.clear()
    _WEIGHTS[n] = out
    return out


def host_fingerprint(arr: np.ndarray) -> int:
    """The host twin of the device checksum: sum(v[i]*w[i]) mod 2**32
    over the int32 bit patterns of `arr` (bool/int64 inputs cast the
    same way the device mirror upload casts them)."""
    v = np.ascontiguousarray(np.asarray(arr).astype(np.int32)).view(np.uint32)
    w = host_weights(len(v))
    prod = (v.astype(np.uint64) * w.astype(np.uint64)) & _MASK32
    return int(np.sum(prod, dtype=np.uint64) & _MASK32)


_DEV_WEIGHTS: Dict[Tuple[int, str], torch.Tensor] = {}


def _device_weights(n: int, device: torch.device) -> torch.Tensor:
    """`host_weights(n)` as int64 on `device`, cached per (n, device)."""
    key = (n, str(device))
    w = _DEV_WEIGHTS.get(key)
    if w is None:
        i = torch.arange(n, dtype=torch.int64, device=device)
        w = ((i * _FP_MUL + _FP_ADD) & _MASK32) | 1
        if len(_DEV_WEIGHTS) > 64:
            _DEV_WEIGHTS.clear()
        _DEV_WEIGHTS[key] = w
    return w


def _device_fp1(v: torch.Tensor) -> torch.Tensor:
    """One tensor's checksum on its own device, as an int64 scalar in
    [0, 2**32): the same arithmetic as host_fingerprint. Each product of
    an int32 value and a weight below 2**32 fits in int64 and is masked
    to its low 32 bits, the int32 product's wrapped bits; the sum of
    those stays below 2**63 for any tensor under 2**31 elements, and
    the final mask wraps it mod 2**32."""
    x = v.reshape(-1).to(torch.int32).to(torch.int64)
    prod = (x * _device_weights(x.shape[0], x.device)) & _MASK32
    return prod.sum() & _MASK32


def device_fingerprints(buffers) -> np.ndarray:
    """One uint32 checksum per tensor (one device-to-host copy for the
    lot), matching host_fingerprint."""
    fps = torch.stack([_device_fp1(b) for b in buffers])
    return fps.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# seeded device corruption (the chaos poison flip)
# ---------------------------------------------------------------------------


def corrupt_flip(buf: torch.Tensor, idx: int, bit: int) -> torch.Tensor:
    """The chaos-only poison flip: a new tensor equal to `buf` with bit
    `bit` of element `idx` flipped. It exists to prove that the
    fingerprints catch exactly this fault."""
    new = buf.clone()
    new[idx] ^= 1 << bit
    return new


def apply_device_corruption(resident, spec: Dict) -> None:
    """Apply one injected device-tensor bit flip to a
    DeviceResidentState mirror. `spec` is FaultInjector.
    device_corruption()'s draw: {"array", "index", "bit"}; plan tensors
    are addressed as "p_<name>". The caller must rebind any outstanding
    problem handle afterwards (the flip produces a NEW tensor)."""
    name = spec["array"]
    attr = {
        "p_arc": "d_p_arc", "p_sign": "d_p_sign",
        "p_src": "d_p_src", "p_dst": "d_p_dst",
    }.get(name, "d_" + name)
    buf = getattr(resident, attr, None)
    if buf is None:
        return  # mirror not built for that family yet: flip has no target
    idx = int(spec["index"]) % int(buf.shape[0])
    setattr(resident, attr, corrupt_flip(buf, idx, int(spec["bit"]) % 31))


# ---------------------------------------------------------------------------
# the auditor + divergence repair ladder
# ---------------------------------------------------------------------------


class StateAuditor:
    """Cross-checks a DeviceResidentState mirror against the host
    journal-maintained arrays (the source of truth) via fingerprints,
    and repairs divergence through an escalating ladder.

    Must run at the post-refresh point of a round (host and mirror are
    in sync by construction there); graph/slot-plan mutations between
    refreshes legitimately put the mirror behind and are not audited.
    """

    #: repair rungs this auditor owns, cheapest first; the caller
    #: (solver/placement.py) escalates to full_build when all fail.
    #: No separate plan-rebuild rung: the fingerprints compare device
    #: against HOST truth, so "reupload" makes the mirror exact by
    #: construction — host-side plan damage is a different detector's
    #: job (SlotPlanState.check_invariants) and is healed by the
    #: full_build escalation, which rebuilds the plan layout.
    RUNGS = ("rescatter", "reupload")

    def __init__(self, resident) -> None:
        self.resident = resident
        self.counts: Counter = Counter()
        # host-twin fingerprint caches: problem arrays are never
        # mutated in place (problem() copies per re-materialized
        # group), so identity-keyed caching makes the per-round host
        # cost O(changed groups); plan arrays ARE mutated in place, so
        # their cache keys on (layout_gen, value_version)
        self._fp_state_cache: Dict[str, Tuple] = {}  # name -> (array ref, fp)
        self._fp_plan_cache: Optional[Tuple] = None  # (key, fps list)
        self._fp_warm_cache: Optional[Tuple] = None  # (array ref, fp)
        reg = get_registry()
        self._m_audits = reg.counter(
            "ksched_state_audits_total",
            "device-state integrity audits, by result",
            labelnames=("result",),
        )
        self._m_repairs = reg.counter(
            "ksched_state_repairs_total",
            "divergence repairs, by ladder rung that healed the state",
            labelnames=("rung",),
        )
        self._m_diverged = reg.counter(
            "ksched_state_divergence_total",
            "device buffers observed diverged from the host truth",
            labelnames=("array",),
        )

    # -- expectations ------------------------------------------------------

    def expected_state(self) -> Dict[str, np.ndarray]:
        problem = self.resident.state.problem()
        return {
            "excess": problem.excess.astype(np.int32),
            "src": problem.src,
            "dst": problem.dst,
            "cap": problem.cap,
            "cost": problem.cost.astype(np.int32),
        }

    def _plan_in_sync(self) -> bool:
        plan = self.resident.state.plan
        r = self.resident
        return (
            plan is not None
            and plan.enabled
            and not plan.needs_rebuild
            and r._plan_gen == plan.layout_gen
            and r._plan_ver == plan.value_version
            and not plan.has_pending
        )

    def expected_plan(self) -> Dict[str, np.ndarray]:
        plan = self.resident.state.plan
        return {name: getattr(plan, name) for name in FP_PLAN_ARRAYS}

    # -- audit -------------------------------------------------------------

    def audit(self, warm_flow=None, warm_expected=None) -> List[str]:
        """Fingerprint-compare every in-sync device tensor family
        against its host twin; returns the diverged array names
        (empty = clean). `warm_flow`/`warm_expected` optionally audit
        a solver's carried device flow against its host copy."""
        diverged = self._compare(warm_flow, warm_expected)
        self.counts["audits"] += 1
        if diverged:
            self.counts["divergences"] += 1
            self._m_audits.labels(result="divergence").inc()
            for name in diverged:
                self._m_diverged.labels(array=name).inc()
            self._note_event(diverged)
        else:
            self._m_audits.labels(result="ok").inc()
        return diverged

    def _compare(self, warm_flow=None, warm_expected=None) -> List[str]:
        """The raw fingerprint comparison, counting nothing — repair's
        per-rung re-verification uses this so rung retries can't
        inflate the audit/divergence metrics or duplicate the soltel
        event."""
        r = self.resident
        diverged: List[str] = []
        if r.d_excess is not None:
            dev = device_fingerprints(
                tuple(getattr(r, "d_" + n) for n in FP_STATE_ARRAYS)
            )
            problem = r.state.problem()
            for i, name in enumerate(FP_STATE_ARRAYS):
                arr = getattr(problem, name)
                ref, fp = self._fp_state_cache.get(name, (None, -1))
                if ref is not arr:  # group re-materialized since
                    fp = host_fingerprint(arr)
                    self._fp_state_cache[name] = (arr, fp)
                if int(dev[i]) != fp:
                    diverged.append(name)
        if self._plan_in_sync():
            plan = r.state.plan
            dev = r.plan_fingerprints()
            key = (plan.layout_gen, plan.value_version)
            if self._fp_plan_cache is None or self._fp_plan_cache[0] != key:
                self._fp_plan_cache = (
                    key,
                    [host_fingerprint(getattr(plan, name)) for name in FP_PLAN_ARRAYS],
                )
            fps = self._fp_plan_cache[1]
            for i, name in enumerate(FP_PLAN_ARRAYS):
                if int(dev[i]) != fps[i]:
                    diverged.append(name)
        if (
            warm_flow is not None
            and warm_expected is not None
            and warm_flow.shape[0] == len(warm_expected)
        ):
            got = int(_device_fp1(warm_flow))
            if self._fp_warm_cache is None or self._fp_warm_cache[0] is not warm_expected:
                self._fp_warm_cache = (warm_expected, host_fingerprint(warm_expected))
            if got != self._fp_warm_cache[1]:
                diverged.append("warm_flow")
        return diverged

    def diffs(self, diverged: List[str]) -> List[IntegrityError]:
        """Bounded per-array diffs for a divergence (fetches the
        diverged tensors; repair path only)."""
        r = self.resident
        host = self.expected_state()
        plan_host = self.expected_plan() if self._plan_in_sync() else {}
        out = []
        attr = {
            "inv_order": "d_inv", "seg_start": "d_seg",
            "is_start": "d_isstart", "node_first": "d_first",
            "node_last": "d_last", "node_nonempty": "d_nonempty",
        }
        for name in diverged:
            if name == "warm_flow":
                out.append(IntegrityError("warm_flow diverged", array=name))
                continue
            want = host.get(name)
            if want is None:
                want = plan_host.get(name)
                dev = getattr(r, attr.get(name, "d_" + name))
            else:
                dev = getattr(r, "d_" + name)
            got = dev.cpu().numpy().astype(np.int32)
            out.append(bounded_diff(name, got, want.astype(np.int32)))
        return out

    def _note_event(self, diverged: List[str]) -> None:
        from ..obs import soltel

        soltel.note_stall(
            {
                "kind": "state_divergence",
                "arrays": list(diverged),
                "detail": (
                    "device mirror diverged from the host journal truth: "
                    + ", ".join(diverged)
                ),
                "diffs": [e.to_dict() for e in self.diffs(diverged)],
            }
        )

    # -- repair ladder -----------------------------------------------------

    def repair(self, diverged: List[str]) -> str:
        """Escalate through the repair rungs until a re-verification
        (counting nothing) comes back clean; returns the rung that
        healed the state. Raises IntegrityError when every rung fails OR
        when the divergence includes state these rungs cannot reach (the
        warm flow lives on the solver, not the mirror) — the caller then
        owns the full_build escalation, which also drops solver warm
        state via backend.reset()."""
        if "warm_flow" in diverged:
            raise IntegrityError(
                "carried warm flow diverged: no mirror rung can repair "
                "solver-owned state; escalate to full_build (which "
                "resets the solver's warm carry)",
                array="warm_flow",
            )
        plan_dirty = any(n in FP_PLAN_ARRAYS for n in diverged)
        for rung in self.RUNGS:
            if rung == "rescatter" and plan_dirty:
                continue  # row-level rescatter covers problem arrays only
            getattr(self, "_repair_" + rung)(diverged)
            if not self._compare():
                self.counts[f"repair_{rung}"] += 1
                self._m_repairs.labels(rung=rung).inc()
                return rung
        raise IntegrityError(
            "divergence repair ladder exhausted "
            f"(arrays: {', '.join(diverged)}); escalate to full_build",
            array=",".join(diverged),
        )

    def _repair_rescatter(self, diverged: List[str]) -> None:
        """Re-scatter exactly the diverged rows through the delta apply
        (O(diff), the cheapest rung)."""
        r = self.resident
        host = self.expected_state()
        slots: set = set()
        nodes: set = set()
        for name in diverged:
            dev = getattr(r, "d_" + name).cpu().numpy()
            bad = np.nonzero(dev != host[name])[0]
            (nodes if name == "excess" else slots).update(int(i) for i in bad)
        arc_rec = r._pack_arcs(np.sort(np.fromiter(slots, np.int32, len(slots))))
        node_rec = r._pack_nodes(np.sort(np.fromiter(nodes, np.int32, len(nodes))))
        r._apply(arc_rec, node_rec)
        r._scaled = None

    def _repair_reupload(self, diverged: List[str]) -> None:
        """Full problem re-upload + full plan tensor re-upload from the
        host truth (exact values: placement parity preserved)."""
        r = self.resident
        r._full_upload(r.state.problem(), arcs_too=True)
        r._scaled = None
        if r.state.plan is not None and r.state.plan.enabled:
            r._plan_gen = -1  # force the rebuild-upload path
            r._sync_plan()


# ---------------------------------------------------------------------------
# WAL record framing (checkpoint manifests; see runtime/checkpoint.py)
# ---------------------------------------------------------------------------

WAL_MAGIC = b"KSWAL1\n"


class WALCorrupted(RuntimeError):
    """A WAL/manifest stream failed validation. `kind` is one of
    "bad_magic", "truncated", "crc", "seq_gap", "seq_dup" — torn
    writes, dropped records and duplicated records are DISTINCT, so
    chaos tests can assert the detector classifies each fault."""

    def __init__(self, kind: str, detail: str) -> None:
        super().__init__(f"WAL corrupted ({kind}): {detail}")
        self.kind = kind


def write_records(path: str, records: List[Tuple[str, bytes]]) -> None:
    """Write `(kind, payload)` records as a seq-numbered, CRC-framed
    stream. Written to a temp file and renamed, so a crash mid-write
    leaves either the old manifest or none (a partial new one is only
    reachable through injected torn-write chaos)."""
    tmp = path + ".tmp"
    framed = list(records) + [
        # end-of-stream footer: without it, dropping the FINAL record
        # would read back as a clean shorter stream
        ("__end__", json.dumps({"count": len(records)}).encode()),
    ]
    with open(tmp, "wb") as f:
        f.write(WAL_MAGIC)
        for seq, (kind, payload) in enumerate(framed):
            hdr = json.dumps(
                {"seq": seq, "kind": kind, "len": len(payload),
                 "crc": zlib.crc32(payload)}
            ).encode()
            f.write(struct.pack("<I", len(hdr)))
            f.write(hdr)
            f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_records(path: str) -> List[Tuple[str, bytes]]:
    """Read and VALIDATE a record stream; raises WALCorrupted with a
    distinct kind for each corruption class."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(WAL_MAGIC):
        raise WALCorrupted("bad_magic", f"{path} is not a ksched WAL/manifest")
    off = len(WAL_MAGIC)
    out: List[Tuple[str, bytes]] = []
    expected_seq = 0
    while off < len(data):
        if off + 4 > len(data):
            raise WALCorrupted("truncated", f"torn frame header at byte {off}")
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        if off + hlen > len(data):
            raise WALCorrupted("truncated", f"torn record header at byte {off}")
        try:
            hdr = json.loads(data[off:off + hlen])
        except ValueError as e:
            raise WALCorrupted("crc", f"unparseable record header: {e}") from e
        off += hlen
        plen = int(hdr["len"])
        if off + plen > len(data):
            raise WALCorrupted(
                "truncated",
                f"record {hdr.get('seq')} payload torn "
                f"({len(data) - off}/{plen} bytes)",
            )
        payload = data[off:off + plen]
        off += plen
        if zlib.crc32(payload) != int(hdr["crc"]):
            raise WALCorrupted("crc", f"record {hdr.get('seq')} failed its CRC")
        seq = int(hdr["seq"])
        if seq < expected_seq:
            raise WALCorrupted("seq_dup", f"record seq {seq} delivered twice")
        if seq > expected_seq:
            raise WALCorrupted(
                "seq_gap", f"record seq {expected_seq} missing (next is {seq})"
            )
        expected_seq += 1
        out.append((str(hdr["kind"]), payload))
    if not out or out[-1][0] != "__end__":
        raise WALCorrupted(
            "truncated", "end-of-stream footer missing (torn tail write)"
        )
    footer = json.loads(out.pop()[1])
    if int(footer.get("count", -1)) != len(out):
        raise WALCorrupted(
            "seq_gap",
            f"footer promises {footer.get('count')} records, stream holds {len(out)}",
        )
    return out


def _raw_frames(data: bytes) -> List[bytes]:
    """Split a stream into raw frame byte strings WITHOUT validation
    (the corruption injector's view)."""
    off = len(WAL_MAGIC)
    frames = []
    while off + 4 <= len(data):
        (hlen,) = struct.unpack_from("<I", data, off)
        end = off + 4 + hlen
        if end > len(data):
            break
        hdr = json.loads(data[off + 4:end])
        end += int(hdr["len"])
        frames.append(data[off:min(end, len(data))])
        off = end
    return frames


def corrupt_wal_file(path: str, mode: str, rng) -> None:
    """Deterministically damage a WAL/manifest file in place — the
    chaos fault classes for checkpoint integrity. `mode`:

    - "wal_drop": remove one middle record (seq gap);
    - "wal_dup": deliver one record twice (seq dup);
    - "wal_torn": truncate the file inside the final record (the torn
      checkpoint write).
    """
    with open(path, "rb") as f:
        data = f.read()
    frames = _raw_frames(data)
    if not frames:
        with open(path, "wb") as f:
            f.write(data[: max(len(data) // 2, 1)])
        return
    if mode == "wal_torn":
        cut = len(data) - 1 - int(rng.integers(0, max(len(frames[-1]) - 1, 1)))
        with open(path, "wb") as f:
            f.write(data[:cut])
        return
    i = int(rng.integers(0, len(frames)))
    if mode == "wal_drop":
        frames.pop(i)
    elif mode == "wal_dup":
        frames.insert(i, frames[i])
    else:
        raise ValueError(f"unknown WAL corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(WAL_MAGIC)
        for fr in frames:
            f.write(fr)
