"""CoCo: co-location interference cost model — its constants.

The reference declares CoCo (costmodel/interface.go:33-43) and carries
its inputs — per-task CoCo classes (task_desc.proto:25-30: Sheep/
Rabbit/Devil/Turtle) and per-machine `CoCoInterferenceScores` penalties
(coco_interference_scores.proto:11-16) — without implementing it. The
policy: the cost of placing a class-c task on a machine is
sum_k census_k(machine) * W[c, k] + penalty(c, machine), clamped to
MAX_COST so the unscheduled escape cost sits above every placement.

This module holds the policy's constants, which the device round's cost
function (costmodels/device_costs.py) uses; the host cost modeler on
the flow graph is not ported yet.
"""

from __future__ import annotations

import numpy as np

# Class-interaction weights W[c, k]: marginal cost of placing a class-c
# task next to one resident class-k task. Order: Sheep, Rabbit, Devil,
# Turtle. Devils (antagonists) hurt everyone and everyone hurts the
# cache-sensitive rabbits; turtles neither give nor take.
INTERFERENCE = np.array(
    [
        # resident:  S   R   D   T
        [2, 1, 8, 0],  # incoming sheep
        [4, 3, 16, 0],  # incoming rabbit
        [8, 12, 10, 1],  # incoming devil
        [0, 0, 1, 0],  # incoming turtle
    ],
    dtype=np.int64,
)

MAX_COST = 2_000  # clamp so unsched cost can dominate
UNSCHEDULED_COST = MAX_COST + 500
