"""Quincy: data-locality-driven cost model.

The reference enumerates MODEL_QUINCY (costmodel/interface.go:38) without
implementing it, yet Quincy (Isard et al., SOSP'09) is the paper the
whole flow-scheduling architecture comes from. This implements its cost
structure over the rebuild's graph:

- each task has input blocks (TaskDescriptor.dependencies, carried as
  ReferenceDescriptors with ``size`` and ``location`` —
  proto/task_desc.proto:36, reference_desc.proto:38-41, fields the
  reference carries but never reads);
- a block registry maps block id → machines holding a replica;
- cost(task → machine m) = bytes the task would pull across the network
  if placed on m, i.e. total input size minus bytes local to m, scaled
  to COST_PER_MB. Machines holding enough input get direct preference
  arcs (Quincy's "preferred set": > PREFERENCE_FRACTION of input local);
- cost(task → cluster agg) = worst-case transfer (no locality), so the
  aggregator remains the fallback route to any machine;
- cost(task → unscheduled agg) grows with the rounds the task has
  waited (Quincy's wait-time term, bounding starvation: eventually
  waiting costs more than the worst placement).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..data import ResourceTopologyNodeDescriptor
from ..utils import ResourceMap, TaskMap, resource_id_from_string
from .base import CLUSTER_AGGREGATOR_EC, Cost
from .trivial import TrivialCostModel

COST_PER_MB = 1  # cost units per megabyte pulled remotely
MB = 1 << 20
PREFERENCE_FRACTION = 0.5  # direct arc if > 50% of input is local
WAIT_COST_PER_ROUND = 10


class BlockRegistry:
    """block id → machines holding a replica (the GFS/TidyFS view Quincy
    reads; here a first-class registry fed by the driver/trace layer)."""

    def __init__(self) -> None:
        self._locations: Dict[int, Set[int]] = {}
        self._sizes: Dict[int, int] = {}

    def register(self, block_id: int, size: int, machine_ids) -> None:
        self._locations.setdefault(block_id, set()).update(machine_ids)
        self._sizes[block_id] = size

    def drop_machine(self, machine_id: int) -> None:
        for holders in self._locations.values():
            holders.discard(machine_id)

    def holders(self, block_id: int) -> Set[int]:
        return self._locations.get(block_id, set())

    def size(self, block_id: int) -> int:
        return self._sizes.get(block_id, 0)


class QuincyCostModel(TrivialCostModel):
    def __init__(
        self,
        resource_map: ResourceMap,
        task_map: TaskMap,
        leaf_resource_ids,
        max_tasks_per_pu: int,
    ) -> None:
        super().__init__(resource_map, task_map, leaf_resource_ids, max_tasks_per_pu)
        self.blocks = BlockRegistry()
        self._wait_rounds: Dict[int, int] = {}

    # -- locality arithmetic ----------------------------------------------

    def _input_bytes(self, task_id: int) -> Tuple[int, Dict[int, int]]:
        """Returns (total input bytes, {machine id: bytes local there})."""
        td = self.task_map.find(task_id)
        if td is None or not td.dependencies:
            return 0, {}
        total = 0
        local: Dict[int, int] = {}
        for dep in td.dependencies:
            size = dep.size or self.blocks.size(dep.id)
            total += size
            for m in self.blocks.holders(dep.id):
                local[m] = local.get(m, 0) + size
        return total, local

    def _transfer_cost(self, total: int, local_bytes: int) -> int:
        return (COST_PER_MB * max(0, total - local_bytes)) // MB

    # -- arc costs --------------------------------------------------------

    def task_to_unscheduled_agg_cost(self, task_id: int) -> Cost:
        total, _ = self._input_bytes(task_id)
        worst = self._transfer_cost(total, 0)
        waited = self._wait_rounds.get(task_id, 0)
        return worst + 1 + WAIT_COST_PER_ROUND * waited

    def task_to_resource_node_cost(self, task_id: int, resource_id: int) -> Cost:
        total, local = self._input_bytes(task_id)
        return self._transfer_cost(total, local.get(resource_id, 0))

    def task_to_equiv_class_aggregator(self, task_id: int, ec: int) -> Cost:
        if ec != CLUSTER_AGGREGATOR_EC:
            return 0
        total, _ = self._input_bytes(task_id)
        return self._transfer_cost(total, 0)  # worst case: nothing local

    # -- preference enumeration -------------------------------------------

    def get_task_preference_arcs(self, task_id: int) -> List[int]:
        total, local = self._input_bytes(task_id)
        if total == 0:
            return []
        threshold = PREFERENCE_FRACTION * total
        return [m for m, b in local.items() if b > threshold and m in self._machines]

    # -- lifecycle --------------------------------------------------------

    def add_task(self, task_id: int) -> None:
        self._wait_rounds.setdefault(task_id, 0)

    def remove_task(self, task_id: int) -> None:
        self._wait_rounds.pop(task_id, None)

    def remove_machine(self, resource_id: int) -> None:
        super().remove_machine(resource_id)
        self.blocks.drop_machine(resource_id)

    def note_round(self, unscheduled_task_ids) -> None:
        """Bump wait counters after a round; the scheduler calls this with
        the tasks that stayed unscheduled (Quincy's starvation bound)."""
        for t in unscheduled_task_ids:
            if t in self._wait_rounds:
                self._wait_rounds[t] += 1
