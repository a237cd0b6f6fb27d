from .synthetic import (
    add_job,
    add_machine,
    add_task_to_job,
    build_cluster,
    build_machine_topology,
    make_coordinator_root,
    make_resource_desc,
    random_flow_problem,
)
from .scenarios import trivial_preempt_rounds, whare_mixed_rounds
from .device_bulk import device_bulk_rounds, steady_rounds

__all__ = [
    "add_job",
    "add_machine",
    "add_task_to_job",
    "build_cluster",
    "build_machine_topology",
    "device_bulk_rounds",
    "make_coordinator_root",
    "make_resource_desc",
    "random_flow_problem",
    "steady_rounds",
    "trivial_preempt_rounds",
    "whare_mixed_rounds",
]
