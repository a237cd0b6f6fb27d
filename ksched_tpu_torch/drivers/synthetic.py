"""Synthetic cluster driver: fabricate machines, jobs, and tasks.

The fakeMachines analogue (reference: cmd/k8sscheduler/scheduler.go:
37-39,191-202,297-350) plus the in-memory fixture builders the
integration test uses (reference: flowscheduler/schedule_iteration_test.go:
152-331). Machines are built as machine → core* → PU* topologies,
registered into the resource map, and handed to the scheduler; jobs are a
root task plus spawned children under one JobDescriptor.
"""

from __future__ import annotations

from typing import List, Optional

from ..data import (
    JobDescriptor,
    JobState,
    ResourceDescriptor,
    ResourceState,
    ResourceTopologyNodeDescriptor,
    ResourceType,
    TaskDescriptor,
    TaskState,
)
from ..scheduler import FlowScheduler
from ..utils import (
    JobMap,
    ResourceMap,
    ResourceStatus,
    TaskMap,
    rand_uint64,
    resource_id_from_string,
)


def make_resource_desc(
    rtype: ResourceType, friendly_name: str = "", uuid: Optional[int] = None
) -> ResourceDescriptor:
    if uuid is None:
        uuid = rand_uint64()
    return ResourceDescriptor(
        uuid=str(uuid),
        friendly_name=friendly_name or f"{rtype.name.lower()}_{uuid % 10_000}",
        type=rtype,
        state=ResourceState.UNKNOWN,
        schedulable=rtype == ResourceType.PU,
    )


def make_coordinator_root() -> ResourceTopologyNodeDescriptor:
    return ResourceTopologyNodeDescriptor(
        resource_desc=make_resource_desc(ResourceType.COORDINATOR, "coordinator")
    )


def _register_subtree(rtnd: ResourceTopologyNodeDescriptor, resource_map: ResourceMap) -> None:
    rid = resource_id_from_string(rtnd.resource_desc.uuid)
    resource_map.insert(rid, ResourceStatus(descriptor=rtnd.resource_desc, topology_node=rtnd))
    for child in rtnd.children:
        _register_subtree(child, resource_map)


def build_machine_topology(
    num_cores: int,
    pus_per_core: int,
    task_capacity_per_pu: int,
    parent: ResourceTopologyNodeDescriptor,
    machine_index: int = 0,
) -> ResourceTopologyNodeDescriptor:
    """machine → core* → PU* subtree attached under parent (reference:
    schedule_iteration_test.go:257-331 createMachineNode)."""
    machine_rd = make_resource_desc(ResourceType.MACHINE, f"machine_{machine_index}")
    machine = ResourceTopologyNodeDescriptor(
        resource_desc=machine_rd, parent_id=parent.resource_desc.uuid
    )
    parent.children.append(machine)
    for c in range(num_cores):
        core_rd = make_resource_desc(ResourceType.CORE, f"machine_{machine_index}_core_{c}")
        core = ResourceTopologyNodeDescriptor(
            resource_desc=core_rd, parent_id=machine_rd.uuid
        )
        machine.children.append(core)
        for p in range(pus_per_core):
            pu_rd = make_resource_desc(
                ResourceType.PU, f"machine_{machine_index}_core_{c}_pu_{p}"
            )
            pu_rd.task_capacity = task_capacity_per_pu
            pu = ResourceTopologyNodeDescriptor(resource_desc=pu_rd, parent_id=core_rd.uuid)
            core.children.append(pu)
    return machine


def add_machine(
    scheduler: FlowScheduler,
    resource_map: ResourceMap,
    root: ResourceTopologyNodeDescriptor,
    num_cores: int = 1,
    pus_per_core: int = 1,
    task_capacity_per_pu: int = 1,
    machine_index: int = 0,
) -> ResourceTopologyNodeDescriptor:
    machine = build_machine_topology(
        num_cores, pus_per_core, task_capacity_per_pu, root, machine_index
    )
    _register_subtree(machine, resource_map)
    scheduler.register_resource(machine)
    return machine


def add_task_to_job(
    job_id: int, job_map: JobMap, task_map: TaskMap, name: str = ""
) -> TaskDescriptor:
    """Create a task under the job's root task (first task becomes the
    root; reference: schedule_iteration_test.go:212-253)."""
    jd = job_map.find(job_id)
    task_id = rand_uint64()
    td = TaskDescriptor(
        uid=task_id,
        name=name or f"task_{task_id % 100_000}",
        state=TaskState.CREATED,
        job_id=str(job_id),
    )
    if jd is None:
        jd = JobDescriptor(
            uuid=str(job_id),
            name=f"job_{job_id % 100_000}",
            state=JobState.CREATED,
            root_task=td,
        )
        job_map.insert(job_id, jd)
    else:
        jd.root_task.spawned.append(td)
    task_map.insert(task_id, td)
    return td


def add_job(
    scheduler: FlowScheduler,
    job_map: JobMap,
    task_map: TaskMap,
    num_tasks: int,
) -> int:
    """Create a job with num_tasks tasks and register it (reference:
    schedule_iteration_test.go:152-162)."""
    job_id = rand_uint64()
    for _ in range(num_tasks):
        add_task_to_job(job_id, job_map, task_map)
    jd = job_map.find(job_id)
    if jd is not None:
        scheduler.add_job(jd)
    return job_id


def build_cluster(
    num_machines: int,
    num_cores: int = 1,
    pus_per_core: int = 1,
    max_tasks_per_pu: int = 1,
    backend=None,
    cost_model_factory=None,
    preemption: bool = False,
    device_resident: bool = False,
):
    """Assemble maps + root + scheduler + machines in one call. Returns
    (scheduler, resource_map, job_map, task_map, root).
    ``device_resident`` keeps the solver's problem on the backend's
    device between rounds (PlacementSolver)."""
    resource_map = ResourceMap()
    job_map = JobMap()
    task_map = TaskMap()
    root = make_coordinator_root()
    resource_map.insert(
        resource_id_from_string(root.resource_desc.uuid),
        ResourceStatus(descriptor=root.resource_desc, topology_node=root),
    )
    scheduler = FlowScheduler(
        resource_map,
        job_map,
        task_map,
        root,
        max_tasks_per_pu=max_tasks_per_pu,
        cost_model_factory=cost_model_factory,
        backend=backend,
        preemption=preemption,
        device_resident=device_resident,
    )
    for i in range(num_machines):
        add_machine(
            scheduler, resource_map, root, num_cores, pus_per_core, max_tasks_per_pu, machine_index=i
        )
    return scheduler, resource_map, job_map, task_map, root


def random_flow_problem(rng, num_tasks: int, num_machines: int,
                        slots_per_machine: int, num_jobs: int = 3,
                        arc_slots: Optional[int] = None):
    """A random scheduling flow network in flat arrays, drawn from the
    numpy Generator `rng`: tasks -> (job unsched aggregator | one EC
    | now and then a machine) ; EC -> machines ; machine -> its slot
    PUs ; PU -> sink ; aggregators -> sink. Node 0 is the padding row.
    `arc_slots` pads the arc arrays with zero-capacity (0, 0) self-loops
    to that length, as the graph export pads its arc extent. The same
    draws, in the same order, as the JAX package's test graphs
    (tests/test_jax_solver.py random_scheduling_problem)."""
    import numpy as np

    from ..graph.device_export import FlowProblem

    tasks = np.arange(1, 1 + num_tasks)
    ec = 1 + num_tasks
    machines = np.arange(ec + 1, ec + 1 + num_machines)
    first_pu = ec + 1 + num_machines
    unscheds = first_pu + num_machines * slots_per_machine + np.arange(num_jobs)
    sink = int(unscheds[-1]) + 1
    n = sink + 1
    arcs = []
    for i, t in enumerate(tasks.tolist()):
        arcs.append((t, int(unscheds[i % num_jobs]), 1, int(rng.integers(3, 10))))
        arcs.append((t, ec, 1, int(rng.integers(0, 5))))
        if rng.random() < 0.3:
            m = int(rng.integers(0, num_machines))
            arcs.append((t, int(machines[m]), 1, int(rng.integers(0, 3))))
    for m in range(num_machines):
        arcs.append((ec, int(machines[m]), slots_per_machine, int(rng.integers(0, 4))))
        for k in range(slots_per_machine):
            pu = first_pu + m * slots_per_machine + k
            arcs.append((int(machines[m]), pu, 1, 0))
            arcs.append((pu, sink, 1, 0))
    for u in unscheds.tolist():
        arcs.append((u, sink, num_tasks, 0))
    live = len(arcs)
    if arc_slots is not None:
        if arc_slots < live:
            raise ValueError(f"{live} arcs do not fit {arc_slots} slots")
        arcs += [(0, 0, 0, 0)] * (arc_slots - live)
    a = np.array(arcs, np.int64).reshape(-1, 4)
    excess = np.zeros(n, np.int64)
    excess[tasks] = 1
    excess[sink] = -num_tasks
    return FlowProblem(
        num_nodes=n, excess=excess, node_type=np.zeros(n, np.int8),
        src=a[:, 0].astype(np.int32), dst=a[:, 1].astype(np.int32),
        cap=a[:, 2].astype(np.int32), cost=a[:, 3].astype(np.int32),
        flow_offset=np.zeros(len(a), np.int32), num_arcs=live,
    )
