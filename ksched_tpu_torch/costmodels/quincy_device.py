"""Quincy on the device fast path: interchangeability-group registry.

The host graph path wires Quincy's per-task preference arcs directly
into the flow graph (graph/graph_manager.py; reference:
graph_manager.go:1229-1264 + costmodel/interface.go:105-110
GetTaskPreferenceArcs) and solves CSR — correct, but ~160 us/superstep:
no route to the <10 ms round regime at 10k x 1k. This module is the
dense alternative: tasks with the SAME cost signature — class,
escape cost, and per-machine transfer-cost profile (i.e. the same input
blocks) — are one transport commodity, so per-TASK preference arcs
become per-GROUP preference columns (GroupSpec.pref_w) min'd into the
class cost row, and the whole Quincy policy rides the dense [G, M]
transport solve (solver/layered.py; scheduler/device_bulk.py group
mode).

Exactness: grouping by full cost signature is the definition of
interchangeability, so the aggregate collapse argument of
solver/layered.py applies row-for-row; the effective per-cell cost
min(EC route, preference arc) is exactly the cheaper of the two
parallel paths a task has in the reference graph.

In Quincy workloads the grouping is massively compressive: tasks
reading the same block(s) share a signature (the map-task pattern), so
G tracks the number of distinct inputs, not the number of tasks. Tasks
whose signature would overflow the static group capacity fall back to
the class's OVERFLOW group — no preferences, priced at the largest
worst-case transfer seen among overflowed signatures, so their
reported cost is conservative (never under the true route cost); the
overflow count is reported so callers can size G_cap properly.

The wait-cost starvation bound (QuincyCostModel.note_round,
WAIT_COST_PER_ROUND) ages at GROUP granularity here: bump_wait raises
the escape cost of groups that still have backlog. Tasks of one group
are admitted and aged together, which preserves the bound's purpose —
eventually waiting costs more than the worst placement.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.spans import span
from .quincy import (
    COST_PER_MB,
    MB,
    PREFERENCE_FRACTION,
    WAIT_COST_PER_ROUND,
    BlockRegistry,
)

#: re-exported sentinel (scheduler/device_bulk.py) so callers need one import
from ..scheduler.device_bulk import PREF_NONE  # noqa: F401

#: distinct overflowed signatures tracked exactly before the counter
#: degrades to a per-event upper bound (see QuincyGroupTable)
_OVERFLOW_TRACK_CAP = 1 << 16


def _transfer_cost(total: int, local: int, unit_mb: int = 1) -> int:
    return (COST_PER_MB * max(0, total - local)) // (MB * unit_mb)


class QuincyGroupTable:
    """Host-side registry: task input signature -> transport group.

    Maintains the numpy mirrors of GroupSpec and pushes them to a
    DeviceBulkCluster via ``sync`` (a host -> device upload; only the
    cluster's public ``set_groups`` is called).
    """

    def __init__(
        self,
        num_groups: int,
        num_machines: int,
        num_classes: int = 1,
        wait_cost_per_round: int = WAIT_COST_PER_ROUND,
        cost_unit_mb: int = 1,
        sig_unit_mb: Optional[int] = None,
    ) -> None:
        """cost_unit_mb quantizes transfer costs to that many megabytes
        per cost unit (default 1 = the QuincyCostModel scale). Large
        heterogeneous inputs (multi-GB reads) want coarser units: cost
        GAPS measured in units bound the price-war descent depth of the
        solve (a war burns ~gap/eps supersteps), and MB precision on
        GB-scale transfers buys no placement quality. Quantization also
        merges near-identical signatures — deliberate compression.

        sig_unit_mb (default = cost_unit_mb) quantizes the GROUPING KEY
        independently of the stored costs: the two pull opposite ways —
        a coarse signature quantum merges near-identical templates
        (fewer distinct signatures, less overflow, smaller quality
        gap), while a fine cost quantum keeps cross-group cost ties
        rare (exact ties herd the synchronous solve). A merged group
        carries its first-registered template's costs at cost_unit
        resolution — representative of the merged set, the same
        approximation grouping itself makes."""
        if num_groups < 2 * num_classes:
            raise ValueError(
                f"need a fallback and an overflow group per class: "
                f"G={num_groups} < 2*C={2 * num_classes}"
            )
        self.G = int(num_groups)
        self.M = int(num_machines)
        self.C = int(num_classes)
        self.wait_cost_per_round = int(wait_cost_per_round)
        self.cost_unit_mb = int(cost_unit_mb)
        self.sig_unit_mb = int(
            cost_unit_mb if sig_unit_mb is None else sig_unit_mb
        )
        if self.sig_unit_mb < self.cost_unit_mb:
            raise ValueError(
                f"sig_unit_mb ({self.sig_unit_mb}) must be >= cost_unit_mb "
                f"({self.cost_unit_mb}): a finer signature quantum would "
                "split cost-identical templates into distinct groups"
            )
        self.blocks = BlockRegistry()
        # Groups 0..C-1 are the classes' no-input fallback groups;
        # C..2C-1 are the per-class OVERFLOW groups (signatures that
        # arrive after the table fills): no preferences, e/u raised to
        # the largest worst-case transfer among overflowed signatures —
        # a conservative (never-undercharging) price.
        self.cls = np.zeros(self.G, np.int32)
        self.cls[: self.C] = np.arange(self.C)
        self.cls[self.C : 2 * self.C] = np.arange(self.C)
        self.job = np.zeros(self.G, np.int32)
        self.e = np.zeros(self.G, np.int64)
        self.u = np.ones(self.G, np.int64)  # worst(0) + 1
        self.pref_w = np.full((self.G, self.M), PREF_NONE, np.int64)
        self.wait_rounds = np.zeros(self.G, np.int64)
        # note: the class fallback groups (gid < C) are matched by the
        # explicit zero-cost check in group_for, not by this dict — a
        # coarse sig quantum can floor a NONZERO-cost signature to
        # (c, 0, ()), which must not collide with them
        self._sig2gid: Dict[tuple, int] = {}
        self._gid2sig: Dict[int, tuple] = {}
        #: signatures currently memoized to each class's overflow gid
        self._overflow_sigs: Dict[int, set] = {}
        #: signatures that have EVER overflowed — never cleared by
        #: evict_idle, so `overflowed` keeps counting DISTINCT
        #: signatures even when un-pinned memoizations re-overflow.
        #: Bounded: past _OVERFLOW_TRACK_CAP distinct signatures the
        #: set stops growing and the counter increments per overflow
        #: event instead (an upper bound) — a G_cap-sizing signal that
        #: large is already saturated, and exact distinctness forever
        #: would be unbounded history (the thing evict_idle exists to
        #: avoid).
        self._overflowed_ever: set = set()
        self._next = 2 * self.C
        self._free: List[int] = []  # evicted gids, reusable
        #: monotonic use clock + last-use stamp per gid (LRU eviction)
        self._clock = 0
        self._last_use: Dict[int, int] = {}
        self.overflowed = 0  # DISTINCT signatures dropped to the overflow group
        self.evicted = 0  # groups reclaimed by evict_idle

    # -- registration ------------------------------------------------------

    def group_for(
        self,
        task_class: int,
        block_ids: Sequence[int],
        job: int = 0,
    ) -> int:
        """The group for a task of `task_class` reading `block_ids`
        (sizes/locations from the block registry). Registers a new
        group on first sight of a signature; overflows to the class's
        no-preference fallback group when the table is full."""
        total = 0
        local: Dict[int, int] = {}
        for b in block_ids:
            size = self.blocks.size(b)
            total += size
            for m in self.blocks.holders(b):
                local[m] = local.get(m, 0) + size
        worst = _transfer_cost(total, 0, self.cost_unit_mb)
        threshold = PREFERENCE_FRACTION * total
        # one pass emits both the stored costs (cost_unit) and the
        # grouping key's quantized values (sig_unit >= cost_unit merges
        # near-identical templates; stored costs stay fine so
        # cross-group cost ties stay rare)
        prefs: List[Tuple[int, int]] = []
        sig_prefs: List[Tuple[int, int]] = []
        for m, b in sorted(local.items()):
            if b > threshold and 0 <= m < self.M:
                prefs.append((m, _transfer_cost(total, b, self.cost_unit_mb)))
                sig_prefs.append(
                    (m, _transfer_cost(total, b, self.sig_unit_mb))
                )
        # the TRUE (cost-unit) values decide fallback membership: a
        # coarse sig quantum must not collapse a nonzero-cost template
        # onto the zero-cost fallback group
        if not prefs and worst == 0:
            return int(task_class)  # the fallback group IS this signature
        sig = (
            int(task_class),
            _transfer_cost(total, 0, self.sig_unit_mb),
            tuple(sig_prefs),
        )
        self._clock += 1
        gid = self._sig2gid.get(sig)
        if gid is not None:
            self._last_use[gid] = self._clock
            if self.C <= gid < 2 * self.C:
                # overflow rows stay conservative across MERGED
                # templates too: a memoized hit can carry a worst up to
                # one sig quantum above the first registrant's
                self.e[gid] = max(self.e[gid], worst)
                self.u[gid] = self.e[gid] + 1
            return gid
        if self._free:
            gid = self._free.pop()
        elif self._next < self.G:
            gid = self._next
            self._next += 1
        else:
            # table full: land in the class's overflow group, repriced
            # upward to cover the costliest overflowed signature. The
            # signature is memoized to the overflow gid so repeated
            # registrations (task multiplicity) don't inflate the
            # distinct-signatures-dropped counter — and the persistent
            # ever-overflowed set keeps it distinct across evict_idle
            # cycles (which un-pin memoizations).
            if len(self._overflowed_ever) < _OVERFLOW_TRACK_CAP:
                self._overflowed_ever.add(sig)
                self.overflowed = len(self._overflowed_ever)
            elif sig not in self._overflowed_ever:
                self.overflowed += 1  # upper bound past the cap
            gid = self.C + int(task_class)
            self._sig2gid[sig] = gid
            self._overflow_sigs.setdefault(gid, set()).add(sig)
            self.e[gid] = max(self.e[gid], worst)
            self.u[gid] = self.e[gid] + 1
            return gid
        self._sig2gid[sig] = gid
        self._gid2sig[gid] = sig
        self._last_use[gid] = self._clock
        self.cls[gid] = int(task_class)
        self.job[gid] = int(job)
        # Route base: worst-case transfer (nothing local) — the task ->
        # EC arc cost (QuincyCostModel.task_to_equiv_class_aggregator);
        # escape: worst + 1 (+ wait aging) as in
        # QuincyCostModel.task_to_unscheduled_agg_cost.
        self.e[gid] = worst
        self.u[gid] = worst + 1
        self.pref_w[gid, :] = PREF_NONE
        for m, cost in prefs:
            self.pref_w[gid, m] = cost
        return gid

    def groups_for(
        self,
        classes: np.ndarray,
        deps: Sequence[Sequence[int]],
        jobs: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Vector form of group_for for an admission batch (a
        `group_table` span)."""
        out = np.empty(len(deps), np.int32)
        with span("group_table", op="groups_for"):
            for i, blocks in enumerate(deps):
                out[i] = self.group_for(
                    int(classes[i]),
                    blocks,
                    0 if jobs is None else int(jobs[i]),
                )
        return out

    # -- lifecycle ---------------------------------------------------------

    def evict_idle(
        self, live_per_group: np.ndarray, keep_fraction: float = 0.5
    ) -> int:
        """LRU signature eviction: reclaim registered groups with ZERO
        live tasks, least-recently-used first, until at most
        `keep_fraction` of the dynamic gid range stays occupied (or no
        idle group remains). A long-running cluster's signature table
        would otherwise fill permanently — every evicted gid returns to
        a free pool that group_for reuses BEFORE overflowing, so the
        table tracks the working set instead of history. Reserved
        fallback/overflow gids (< 2C) are never evicted; a group with
        live tasks is never evicted (its row still prices them).

        Call with per-group live counts (from the host mirror of
        admissions/completions, or a fetched state's grp/live arrays)
        at table-maintenance cadence — e.g. between timed chunks;
        follow with sync() to push the cleared rows. Returns the number
        of groups reclaimed. A `group_table` span."""
        with span("group_table", op="evict_idle"):
            return self._evict_idle(live_per_group, keep_fraction)

    def _evict_idle(self, live_per_group, keep_fraction: float) -> int:
        dyn = max(1, self.G - 2 * self.C)
        occupied = len(self._gid2sig)
        target = int(dyn * keep_fraction)
        if occupied <= target:
            return 0
        live = np.asarray(live_per_group)
        idle = [
            gid for gid in self._gid2sig if live[gid] == 0
        ]
        idle.sort(key=lambda g: self._last_use.get(g, 0))
        n_evict = min(len(idle), occupied - target)
        for gid in idle[:n_evict]:
            sig = self._gid2sig.pop(gid)
            self._sig2gid.pop(sig, None)
            self._last_use.pop(gid, None)
            self._free.append(gid)
            self.e[gid] = 0
            self.u[gid] = 1
            self.pref_w[gid, :] = PREF_NONE
            self.wait_rounds[gid] = 0
        self.evicted += n_evict
        # Un-pin overflow memoizations too: once eviction frees room, a
        # signature that first appeared under table pressure must be
        # able to register PROPERLY on next sight — otherwise hot
        # overflowed signatures stay preference-less forever and the
        # table tracks history, not the working set. When an overflow
        # row is also idle, its ratcheted conservative price resets.
        if n_evict:
            for og, sigs in self._overflow_sigs.items():
                for sig in sigs:
                    self._sig2gid.pop(sig, None)
                sigs.clear()
                if live[og] == 0:
                    self.e[og] = 0
                    self.u[og] = 1
        return n_evict

    def drop_machine(self, machine_index: int) -> None:
        """Machine loss: its replicas disappear; existing groups keep
        their (now stale) preference until signatures re-register —
        mirroring the reference, whose preference arcs are pruned on
        the next task update (removeInvalidPrefResArcs,
        graph_manager.go:766-790). We prune eagerly instead: any group
        preferring the machine loses that column."""
        self.blocks.drop_machine(machine_index)
        self.pref_w[:, machine_index] = PREF_NONE

    def bump_wait(self, backlog_per_group: np.ndarray) -> None:
        """Age the escape cost of groups that still have unscheduled
        tasks (the starvation bound, at group granularity). Call with
        the per-group backlog derived from fetched state — outside the
        timed region, at the caller's binding-readback cadence."""
        waited = np.asarray(backlog_per_group) > 0
        self.wait_rounds[waited] += 1
        self.wait_rounds[~waited] = 0

    def effective_u(self) -> np.ndarray:
        return self.u + self.wait_cost_per_round * self.wait_rounds

    # -- device sync -------------------------------------------------------

    def sync(self, cluster) -> None:
        """Push the current table to a DeviceBulkCluster (group mode; a
        `group_table` span)."""
        with span("group_table", op="sync"):
            cluster.set_groups(
                cls=self.cls,
                job=self.job,
                e=self.e,
                u=self.effective_u(),
                pref_w=self.pref_w,
            )
