"""Loop marks: where a recorded program's supersteps and sweeps begin.

A plain solve of the port is a Python loop, one iteration a superstep,
so a recording of it (analysis/op_contracts.py) needs to know where
each iteration starts to count what a superstep does: its host reads,
gathers and collectives. The loops call ``loop_mark(kind)`` as the first
statement of each iteration ("superstep", "sweep", "wave") and
``loop_mark()`` after the loop. With no recorder attached the call
returns at once: it issues no torch operation and reads nothing, so an
unrecorded run's operations are exactly those of the loop without it.
"""

from __future__ import annotations

from typing import List, Optional

#: the recorders attached now (op_contracts.Recorder pushes and pops)
RECORDERS: List = []


def loop_mark(kind: Optional[str] = None) -> None:
    """The start of one iteration of a `kind` loop, or with no kind the
    first operation after a loop."""
    if RECORDERS:
        for rec in RECORDERS:
            rec.mark(kind)
