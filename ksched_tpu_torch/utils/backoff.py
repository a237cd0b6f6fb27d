"""Exponential backoff with jitter and a retry budget.

One policy object shared by every layer that retries transient faults
(the HTTP adapter's binding POSTs and watch loops, podgen's pod
creation): Firmament/Borg-style production schedulers treat control-
plane blips as normal weather, and the retry cadence must be bounded
(budgeted) and de-synchronized (jittered) so a recovering API server
is not stampeded by every client retrying on the same beat.
"""

from __future__ import annotations

import random
from typing import Optional


class ExpBackoff:
    """A budgeted exponential-backoff schedule.

    ``next_delay()`` returns the wait before the next retry, or ``None``
    once the retry budget is exhausted. Delays grow as
    ``base_s * factor**attempt`` capped at ``max_s``, each scaled by a
    uniform jitter in ``[1 - jitter, 1 + jitter]``. Pass a seeded
    ``random.Random`` as ``rng`` for deterministic schedules (the chaos
    soak does); the default draws from a private unseeded stream so
    concurrent backoffs de-correlate.
    """

    def __init__(
        self,
        base_s: float = 0.05,
        max_s: float = 2.0,
        factor: float = 2.0,
        jitter: float = 0.25,
        max_retries: int = 4,
        rng: Optional[random.Random] = None,
    ) -> None:
        if base_s <= 0 or factor < 1.0 or not 0.0 <= jitter < 1.0:
            raise ValueError(
                f"bad backoff parameters: base_s={base_s} factor={factor} "
                f"jitter={jitter}"
            )
        self.base_s = base_s
        self.max_s = max_s
        self.factor = factor
        self.jitter = jitter
        self.max_retries = max_retries
        self.rng = rng if rng is not None else random.Random()
        self.attempt = 0

    def reset(self) -> None:
        self.attempt = 0

    def delay_for(self, attempt: int) -> float:
        """The jittered delay for a given attempt index, budget-free.
        The shared growth/jitter formula for unbounded failure-streak
        backoff (the watch loops); ``next_delay`` is the budgeted view."""
        raw = min(self.max_s, self.base_s * (self.factor ** attempt))
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self.rng.random() - 1.0)
        return raw

    def next_delay(self) -> Optional[float]:
        """The wait before the next retry, or None when the budget is
        spent. Advances the attempt counter."""
        if self.attempt >= self.max_retries:
            return None
        delay = self.delay_for(self.attempt)
        self.attempt += 1
        return delay
