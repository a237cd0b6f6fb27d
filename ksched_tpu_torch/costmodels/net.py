"""Net: network-bandwidth-aware cost model.

The reference enumerates MODEL_NET (costmodel/interface.go:42) without
implementing it. This implements Firmament's net-bw policy idea: tasks
declare a network-bandwidth request (TaskDescriptor.resource_request
.net_bw, proto/task_desc.proto:69 / resource_vector.proto:18) and
machines a capacity (ResourceDescriptor.capacity.net_bw,
resource_desc.proto:57); placement cost rises with the fraction of the
machine's bandwidth already reserved, and machines that cannot fit the
request at all are priced at the gate cost so the flow routes around
them.

Reserved bandwidth is tracked per machine from the tasks bound below it
(ResourceDescriptor.reserved_resources, resource_desc.proto:54) during
the stats traversal, keeping the one-pass-per-round contract of
gather_stats (costmodel/interface.go:120-127).

Known quantization limit (inherent to flow-based scheduling, the issue
the CoCo line of work exists to solve): the gate prices each task
against ROUND-START reservations, so several tasks placed in one round
can collectively overcommit a machine each would individually fit.
Reservations refresh between rounds, so steady-state incremental
scheduling (small per-round batches, the reference's operating regime)
converges; large cold batches of bandwidth-heavy tasks can transiently
overcommit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..data import ResourceDescriptor, ResourceType
from ..graph.flowgraph import Node, NodeType
from ..utils import ResourceMap, TaskMap, resource_id_from_string
from .base import CLUSTER_AGGREGATOR_EC, Cost
from .trivial import TrivialCostModel

CONGESTION_SCALE = 100  # cost at 100% bandwidth reservation
GATE_COST = 10 * CONGESTION_SCALE  # machine cannot fit the request
# Above every feasible congestion price but BELOW the gate: a task whose
# request fits nowhere stays unscheduled rather than overcommitting a
# gated machine.
UNSCHEDULED_COST = 2 * CONGESTION_SCALE


class NetCostModel(TrivialCostModel):
    def __init__(
        self,
        resource_map: ResourceMap,
        task_map: TaskMap,
        leaf_resource_ids,
        max_tasks_per_pu: int,
    ) -> None:
        super().__init__(resource_map, task_map, leaf_resource_ids, max_tasks_per_pu)
        # machine rid -> (reserved net bw, capacity net bw)
        self._bw: Dict[int, Tuple[int, int]] = {}

    # -- bandwidth bookkeeping --------------------------------------------

    def _task_request(self, task_id: int) -> int:
        td = self.task_map.find(task_id)
        return int(td.resource_request.net_bw) if td is not None else 0

    def _machine_bw(self, resource_id: int) -> Tuple[int, int]:
        if resource_id in self._bw:
            return self._bw[resource_id]
        rs = self.resource_map.find(resource_id)
        cap = int(rs.descriptor.capacity.net_bw) if rs is not None else 0
        return 0, cap

    def _congestion_cost(self, task_id: int, resource_id: int) -> int:
        request = self._task_request(task_id)
        reserved, cap = self._machine_bw(resource_id)
        if cap <= 0:
            # machine declared no bandwidth capacity: bandwidth-neutral
            return 0 if request == 0 else GATE_COST
        if reserved + request > cap:
            return GATE_COST
        return (CONGESTION_SCALE * (reserved + request)) // cap

    # -- arc costs --------------------------------------------------------

    def task_to_unscheduled_agg_cost(self, task_id: int) -> Cost:
        return UNSCHEDULED_COST

    def task_to_resource_node_cost(self, task_id: int, resource_id: int) -> Cost:
        return self._congestion_cost(task_id, resource_id)

    def task_to_equiv_class_aggregator(self, task_id: int, ec: int) -> Cost:
        return 0

    def get_task_preference_arcs(self, task_id: int) -> List[int]:
        """Direct arcs to every machine, priced by congestion — the EC
        wildcard cannot carry per-(task, machine) bandwidth prices.
        Zero-request tasks route via the aggregator alone (identical
        pricing at a fraction of the arc count)."""
        if self._task_request(task_id) == 0:
            return []
        return list(self._machines.keys())

    def get_task_equiv_classes(self, task_id: int) -> List[int]:
        # A bandwidth-requesting task must NOT get the wildcard-EC route:
        # EC→machine arcs are per-(EC, machine) and cannot carry the
        # per-task gate, so the aggregator would bypass it. Such tasks
        # route only via their (gated) direct arcs + the unsched escape.
        if self._task_request(task_id) > 0:
            return []
        return [CLUSTER_AGGREGATOR_EC]

    def equiv_class_to_resource_node(self, ec: int, resource_id: int) -> Tuple[Cost, int]:
        cost, free = super().equiv_class_to_resource_node(ec, resource_id)
        reserved, cap = self._machine_bw(resource_id)
        if cap > 0:
            cost = (CONGESTION_SCALE * reserved) // cap
        return cost, free

    # -- stats traversal: accumulate reserved bandwidth -------------------

    def prepare_stats(self, accumulator: Node) -> None:
        super().prepare_stats(accumulator)
        if accumulator.is_resource_node and accumulator.resource_descriptor is not None:
            accumulator.resource_descriptor.reserved_resources.net_bw = 0

    def gather_stats(self, accumulator: Node, other: Node) -> Node:
        super().gather_stats(accumulator, other)
        if not accumulator.is_resource_node:
            return accumulator
        acc_rd = accumulator.resource_descriptor
        if not other.is_resource_node:
            if other.type == NodeType.SINK:
                # PU leaf: sum requests of tasks running here.
                acc_rd.reserved_resources.net_bw = sum(
                    self._task_request(t) for t in acc_rd.current_running_tasks
                )
                self._note_machine(acc_rd)
            return accumulator
        acc_rd.reserved_resources.net_bw += other.resource_descriptor.reserved_resources.net_bw
        self._note_machine(acc_rd)
        return accumulator

    def _note_machine(self, rd: ResourceDescriptor) -> None:
        if rd.type == ResourceType.MACHINE:
            rid = resource_id_from_string(rd.uuid)
            self._bw[rid] = (int(rd.reserved_resources.net_bw), int(rd.capacity.net_bw))

    def remove_machine(self, resource_id: int) -> None:
        super().remove_machine(resource_id)
        self._bw.pop(resource_id, None)
