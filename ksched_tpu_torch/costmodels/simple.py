"""The simple policy family: Void, Random, Octopus, SJF.

The reference enumerates these models (costmodel/interface.go:33-43 —
MODEL_VOID, MODEL_RANDOM, MODEL_OCTOPUS, MODEL_SJF) without implementing
any of them; only Trivial exists. These are the TPU-rebuild
implementations, following the published Firmament semantics for each
policy. All four keep the Trivial graph shape — one wildcard cluster
aggregator fanning out to every machine with capacity = free slots
(trivial_cost_modeler.go:76-110) — and differ only in arc pricing, so
they subclass TrivialCostModel and override the cost methods.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..utils import ResourceMap, TaskMap, rng
from .base import CLUSTER_AGGREGATOR_EC, Cost
from .trivial import TrivialCostModel


class VoidCostModel(TrivialCostModel):
    """Every arc is free; placement is solver-arbitrary.

    The plumbing-test model (reference enum MODEL_VOID, interface.go:40):
    with all costs zero, any max-flow is optimal, so this isolates
    graph-construction and flow-decode bugs from pricing bugs. A task is
    as happy unscheduled as placed — tests using it must assert only
    conservation properties, not placement counts.
    """

    UNSCHEDULED_COST = 0
    CLUSTER_AGG_COST = 0


class RandomCostModel(TrivialCostModel):
    """Uniformly random arc prices (reference enum MODEL_RANDOM,
    interface.go:35): placement becomes a seeded shuffle. Useful as a
    chaos baseline — any policy that cannot beat random placement on a
    workload is not earning its arcs. Draws from the framework's global
    seeded RNG (utils.seed_rng) so rounds are reproducible.
    """

    MAX_RANDOM_COST = 1000

    def task_to_unscheduled_agg_cost(self, task_id: int) -> Cost:
        # Strictly above the dearest task→EC→machine path so capacity is
        # still used.
        return 2 * self.MAX_RANDOM_COST + 1

    def task_to_equiv_class_aggregator(self, task_id: int, ec: int) -> Cost:
        return rng().randrange(self.MAX_RANDOM_COST)

    def equiv_class_to_resource_node(self, ec: int, resource_id: int) -> Tuple[Cost, int]:
        _, free = super().equiv_class_to_resource_node(ec, resource_id)
        return rng().randrange(self.MAX_RANDOM_COST), free


class OctopusCostModel(TrivialCostModel):
    """Load balancing: a machine costs its current load (reference enum
    MODEL_OCTOPUS, interface.go:39; Firmament's octopus_cost_model prices
    EC→machine arcs by the number of running tasks below). The flow
    therefore spreads tasks to the least-loaded machines first, and the
    incremental re-solve keeps the spread as load shifts.
    """

    LOAD_COST_SCALE = 10

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._max_slots_seen = 1

    def equiv_class_to_resource_node(self, ec: int, resource_id: int) -> Tuple[Cost, int]:
        rs = self.resource_map.find(resource_id)
        if rs is None:
            raise KeyError(f"no resource status for {resource_id}")
        rd = rs.descriptor
        self._max_slots_seen = max(self._max_slots_seen, rd.num_slots_below)
        free = rd.num_slots_below - rd.num_running_tasks_below
        return self.LOAD_COST_SCALE * rd.num_running_tasks_below, free

    def task_to_unscheduled_agg_cost(self, task_id: int) -> Cost:
        # Must dominate any partially-free machine's price: a full machine
        # of S slots prices S*scale, so anything above (S+1)*scale keeps
        # the escape arc dearer than every machine with a free slot.
        return self.LOAD_COST_SCALE * (self._max_slots_seen + 2)


class SjfCostModel(TrivialCostModel):
    """Shortest job first (reference enum MODEL_SJF, interface.go:36).

    Placement price rises with the task's estimated runtime, so when
    slots are contended the min-cost flow gives them to the shortest
    tasks and routes the long ones through the unscheduled aggregator.
    Runtime estimates are learned per job: an EWMA over the runtimes of
    completed tasks (TaskFinalReport.runtime, task_final_report.proto:
    17), falling back to a neutral default until evidence arrives —
    the pipeline the reference's final_report field exists to feed.
    """

    DEFAULT_RUNTIME_COST = 100
    MAX_RUNTIME_COST = 10_000
    EWMA_WEIGHT = 0.3

    def __init__(
        self,
        resource_map: ResourceMap,
        task_map: TaskMap,
        leaf_resource_ids,
        max_tasks_per_pu: int,
    ) -> None:
        super().__init__(resource_map, task_map, leaf_resource_ids, max_tasks_per_pu)
        self._job_runtime_ewma: Dict[str, float] = {}

    def record_completion(self, job_id: str, runtime: float) -> None:
        """Fold a completed task's runtime into its job's estimate."""
        old = self._job_runtime_ewma.get(job_id)
        if old is None:
            self._job_runtime_ewma[job_id] = runtime
        else:
            self._job_runtime_ewma[job_id] = (
                (1.0 - self.EWMA_WEIGHT) * old + self.EWMA_WEIGHT * runtime
            )

    def estimated_runtime_cost(self, task_id: int) -> int:
        td = self.task_map.find(task_id)
        if td is None:
            return self.DEFAULT_RUNTIME_COST
        est = self._job_runtime_ewma.get(td.job_id)
        if est is None:
            return self.DEFAULT_RUNTIME_COST
        return int(min(max(est, 1.0), self.MAX_RUNTIME_COST))

    def task_to_equiv_class_aggregator(self, task_id: int, ec: int) -> Cost:
        if ec != CLUSTER_AGGREGATOR_EC:
            return 0
        return self.estimated_runtime_cost(task_id)

    def task_to_unscheduled_agg_cost(self, task_id: int) -> Cost:
        return self.MAX_RUNTIME_COST + 1

    def record_task_completion(self, td) -> None:
        runtime = 0.0
        if td.final_report is not None and td.final_report.runtime:
            runtime = float(td.final_report.runtime)
        elif td.finish_time and td.start_time:
            runtime = float(td.finish_time - td.start_time)
        elif td.total_run_time:
            runtime = float(td.total_run_time)
        if runtime > 0:
            self.record_completion(td.job_id, runtime)
