"""CoCo: co-location interference cost model.

The reference declares CoCo (costmodel/interface.go:33-43, enum value
COCO=5) and carries its inputs — per-task CoCo classes
(task_desc.proto:25-30: Sheep/Rabbit/Devil/Turtle) and per-machine
`CoCoInterferenceScores` penalties (coco_interference_scores.proto:
11-16) — but never implements the model. This is a from-scratch
implementation of the policy those inputs describe: the cost of placing
a task on a machine is the expected co-location interference, i.e. how
badly the machine's current residents and the incoming task hurt each
other.

Policy:

- Per-class equivalence classes (census.CLASS_ECS) keep arc fan-out at
  O(T + 4·M): task → class-EC → machine.
- EC(c) → machine cost = Σ_k census_k(machine) · W[c, k] + penalty(c,
  machine), where census is the running-class census maintained by the
  stats traversal, W is the 4×4 class-interaction matrix (devils hurt
  everyone; rabbits are sensitive; turtles barely interact — the
  qualitative CoCo taxonomy), and penalty(c, m) is the machine's own
  per-class score from `CoCoInterferenceScores`.
- Costs are clamped to MAX_COST so the unscheduled escape cost can be
  set above the worst placement: a task is left waiting only when every
  machine is full or pathologically noisy.
- Capacity on EC→machine arcs = free slots below, the same rule the
  trivial model uses (trivial_cost_modeler.go:76-83).

The vectorized form used by the array fast path is
`coco_cost_matrix(census, penalties)`: one [4, M] int32 matrix per
round from an [M, 4] census — pure numpy, no per-arc callbacks.

The device round's cost function (costmodels/device_costs.py) uses
this module's constants.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..data import ResourceDescriptor, ResourceTopologyNodeDescriptor
from ..graph.flowgraph import Node
from ..utils import ResourceMap, TaskMap
from .base import Cost, CostModeler
from .census import CLASS_ECS, ClassCensusKeeper, ec_class

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


def machine_penalty_matrix(rd: ResourceDescriptor) -> np.ndarray:
    """Per-machine additive penalty vector p[c] for incoming class c,
    from the machine's CoCoInterferenceScores."""
    s = rd.coco_interference_scores
    return np.array(
        [s.sheep_penalty, s.rabbit_penalty, s.devil_penalty, s.turtle_penalty],
        dtype=np.int64,
    )


def coco_cost_matrix(census: np.ndarray, penalties: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized CoCo costs.

    census: [M, 4] running-class counts per machine.
    penalties: optional [M, 4] per-machine per-incoming-class penalties.
    Returns [4, M] int32 cost of placing each class on each machine.
    """
    cost = INTERFERENCE @ census.T.astype(np.int64)  # [4, M]
    if penalties is not None:
        cost = cost + penalties.T.astype(np.int64)
    return np.minimum(cost, MAX_COST).astype(np.int32)


class CocoCostModel(CostModeler):
    """Interference-aware placement (TPU-rebuild implementation of the
    reference's planned COCO model, costmodel/interface.go:39)."""

    def __init__(
        self,
        resource_map: ResourceMap,
        task_map: TaskMap,
        leaf_resource_ids,
        max_tasks_per_pu: int,
    ) -> None:
        self.resource_map = resource_map
        self.task_map = task_map
        self.leaf_resource_ids = leaf_resource_ids
        self.census = ClassCensusKeeper(resource_map, task_map, max_tasks_per_pu)

    # -- arc costs --------------------------------------------------------

    def task_to_unscheduled_agg_cost(self, task_id: int) -> Cost:
        return UNSCHEDULED_COST

    def unscheduled_agg_to_sink_cost(self, job_id: int) -> Cost:
        return 0

    def task_to_resource_node_cost(self, task_id: int, resource_id: int) -> Cost:
        c = self.census.task_class(task_id)
        return int(self._machine_cost(c, resource_id))

    def resource_node_to_resource_node_cost(
        self, source: Optional[ResourceDescriptor], destination: ResourceDescriptor
    ) -> Cost:
        return 0

    def leaf_resource_node_to_sink_cost(self, resource_id: int) -> Cost:
        return 0

    def task_continuation_cost(self, task_id: int) -> Cost:
        # Continuing in place is free of *new* interference.
        return 0

    def task_preemption_cost(self, task_id: int) -> Cost:
        return MAX_COST // 2

    def task_to_equiv_class_aggregator(self, task_id: int, ec: int) -> Cost:
        return 0

    def equiv_class_to_resource_node(self, ec: int, resource_id: int) -> Tuple[Cost, int]:
        c = ec_class(ec)
        if c is None:
            return 0, 0
        return int(self._machine_cost(c, resource_id)), self.census.free_slots(resource_id)

    def equiv_class_to_equiv_class(self, ec1: int, ec2: int) -> Tuple[Cost, int]:
        return 0, 0

    def _machine_cost(self, task_class: int, resource_id: int) -> int:
        census = self.census.machine_census(resource_id)
        rs = self.resource_map.find(resource_id)
        pen = machine_penalty_matrix(rs.descriptor)[task_class]
        raw = int(INTERFERENCE[task_class] @ census) + int(pen)
        return min(raw, MAX_COST)

    # -- preference enumeration -------------------------------------------

    def get_task_equiv_classes(self, task_id: int) -> List[int]:
        return [CLASS_ECS[self.census.task_class(task_id)]]

    def get_outgoing_equiv_class_pref_arcs(self, ec: int) -> List[int]:
        if ec_class(ec) is None:
            return []
        return list(self.census.machines.keys())

    def get_task_preference_arcs(self, task_id: int) -> List[int]:
        return []

    def get_equiv_class_to_equiv_classes_arcs(self, ec: int) -> List[int]:
        return []

    # -- lifecycle --------------------------------------------------------

    def add_machine(self, rtnd: ResourceTopologyNodeDescriptor) -> None:
        self.census.add_machine(rtnd)

    def add_task(self, task_id: int) -> None:
        pass

    def remove_machine(self, resource_id: int) -> None:
        self.census.remove_machine(resource_id)

    def remove_task(self, task_id: int) -> None:
        pass

    # -- stats traversal --------------------------------------------------

    def gather_stats(self, accumulator: Node, other: Node) -> Node:
        return self.census.gather(accumulator, other)

    def prepare_stats(self, accumulator: Node) -> None:
        self.census.prepare(accumulator)

    def update_stats(self, accumulator: Node, other: Node) -> Node:
        return accumulator
