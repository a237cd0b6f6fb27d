"""Heartbeat-driven failure detection.

The reference stores heartbeats (ResourceStatus.LastHeartbeat,
resourcestatus.go:26; TaskDescriptor.last_heartbeat_*, task_desc.proto:
46-47) and defines ResourceState LOST (resource_desc.proto:22) but
ships no checker — machine loss must be driven externally through
DeregisterResource (flowscheduler/scheduler.go:162-210). This monitor
closes the loop: heartbeats in, expiry sweep, and the reference's own
reaction machinery out (deregister for lost machines, HandleTaskFailure
for silent tasks).
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, List, Optional, Tuple

from ..data import ResourceState, TaskState
from ..scheduler import FlowScheduler
from ..utils import resource_id_from_string


class HeartbeatMonitor:
    def __init__(
        self,
        scheduler: FlowScheduler,
        machine_timeout_s: float = 30.0,
        task_timeout_s: float = 60.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.scheduler = scheduler
        self.machine_timeout_s = machine_timeout_s
        self.task_timeout_s = task_timeout_s
        self.clock = clock or time.monotonic
        #: heartbeats that arrived for entities we no longer track (a
        #: LOST machine beating again after deregister, a retired task):
        #: ignored, not fatal — re-admission goes through registration,
        #: never through a stray heartbeat resurrecting pruned state.
        self.stale_heartbeats = 0

    # -- heartbeat ingestion ----------------------------------------------

    def record_machine_heartbeat(self, resource_id: int, now: Optional[float] = None) -> bool:
        """Record a machine heartbeat. Returns False (and counts it as
        stale) when the resource is unknown — e.g. a machine that went
        LOST, was deregistered, and then resumed beating; it must
        re-register to rejoin, a heartbeat alone cannot resurrect it."""
        rs = self.scheduler.resource_map.find(resource_id)
        if rs is None:
            self.stale_heartbeats += 1
            return False
        rs.last_heartbeat = now if now is not None else self.clock()
        return True

    def record_task_heartbeat(self, task_id: int, now: Optional[float] = None) -> bool:
        """Record a task heartbeat; False (stale) for unknown tasks."""
        td = self.scheduler.task_map.find(task_id)
        if td is None:
            self.stale_heartbeats += 1
            return False
        # 0 is the proto's never-heartbeated sentinel (task_desc.proto
        # int default), so a genuine beat at t=0 is clamped to 1 ns.
        td.last_heartbeat_time = max(1, int((now if now is not None else self.clock()) * 1e9))
        return True

    # -- expiry sweep ------------------------------------------------------

    def check(self, now: Optional[float] = None) -> Tuple[List[int], List[int]]:
        """One failure-detection sweep. Returns (lost machine resource
        ids, failed task ids). Lost machines are marked LOST and
        deregistered (evicting their tasks back to runnable); silent
        RUNNING tasks are failed via HandleTaskFailure."""
        now = now if now is not None else self.clock()
        lost_machines: List[int] = []
        failed_tasks: List[int] = []

        # Machines: registered roots' machine children with stale beats.
        for rid, rs in self.scheduler.resource_map.items():
            rd = rs.descriptor
            if rd.type.name != "MACHINE":
                continue
            hb = rs.last_heartbeat
            if hb is None:
                continue  # never heartbeated: not monitored
            if now - hb > self.machine_timeout_s and rd.state != ResourceState.LOST:
                rd.state = ResourceState.LOST
                lost_machines.append(rid)

        for rid in lost_machines:
            rs = self.scheduler.resource_map.find(rid)
            if rs is not None and rs.topology_node is not None:
                self.scheduler.deregister_resource(rs.topology_node)

        # Tasks: RUNNING with stale beats (only tasks that ever beat).
        for tid, td in self.scheduler.task_map.items():
            if td.state != TaskState.RUNNING or td.last_heartbeat_time == 0:
                continue
            if td.uid not in self.scheduler.task_bindings:
                continue  # already unbound by a machine loss above
            if now - td.last_heartbeat_time / 1e9 > self.task_timeout_s:
                failed_tasks.append(tid)

        for tid in failed_tasks:
            td = self.scheduler.task_map.find(tid)
            self.scheduler.handle_task_failure(td)
        return lost_machines, failed_tasks


class RoundWatchdog:
    """A per-round deadline watchdog for the scheduler service loop.

    A Python round cannot be preempted mid-solve, so the watchdog does
    the two things that *are* possible: warn from a timer thread the
    moment the deadline passes (observable even if the round never
    returns — the operator's signal that the loop is wedged, not idle),
    and expose ``fired``/``misses`` so the service can record the miss
    in the round trace and treat it as a degradation signal.

    Use as a context manager around the round body; ``deadline_s <= 0``
    disables it.
    """

    def __init__(self, deadline_s: float = 0.0) -> None:
        self.deadline_s = deadline_s
        self.fired = False
        self.misses = 0
        self._timer: Optional[threading.Timer] = None
        self._t0 = 0.0
        # fired/misses are touched by the timer thread and (on a
        # boundary finish) __exit__'s wall-clock check; the lock keeps
        # a miss from being counted twice or read before it lands
        self._lock = threading.Lock()

    def _mark_miss(self) -> bool:
        with self._lock:
            if self.fired:
                return False
            self.fired = True
            self.misses += 1
            return True

    def _expire(self) -> None:
        if self._mark_miss():
            warnings.warn(
                f"scheduling round exceeded its {self.deadline_s:.3f}s deadline "
                "(solver wedged or cluster oversized for the budget)",
                RuntimeWarning,
                stacklevel=2,
            )

    def __enter__(self) -> "RoundWatchdog":
        self.fired = False
        if self.deadline_s > 0:
            self._t0 = time.monotonic()
            self._timer = threading.Timer(self.deadline_s, self._expire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
            # A round finishing right at the deadline races cancel()
            # against the already-dispatched timer callback: the wall
            # clock, not the callback's scheduling luck, decides — so
            # `fired` is settled before the caller reads it.
            if time.monotonic() - self._t0 >= self.deadline_s:
                self._mark_miss()
