"""The port's cost models' signature behaviours (costmodels/simple.py,
net.py), the cases of tests/test_policy_models.py through the port's
scheduler on the CPU, and RandomCostModel's draws against the JAX
package's: the same seed gives every one of a few hundred arcs the same
cost in both packages. Tolerance 0."""

import io

import pytest

from ksched_tpu_torch.costmodels import (
    NetCostModel,
    OctopusCostModel,
    RandomCostModel,
    SjfCostModel,
    VoidCostModel,
)
from ksched_tpu_torch.drivers import add_job, build_cluster
from ksched_tpu_torch.graph.dimacs import export
from ksched_tpu_torch.solver.select import make_backend
from ksched_tpu_torch.utils import resource_id_from_string, seed_rng

jcm = pytest.importorskip("ksched_tpu.costmodels")


def _cluster(model_cls, machines=3, cores=1, pus=2, slots=1):
    return build_cluster(num_machines=machines, num_cores=cores, pus_per_core=pus,
                         max_tasks_per_pu=slots, cost_model_factory=model_cls,
                         backend=make_backend("auto", device="cpu"))


def _machine_of(rmap, pu_rid):
    node = rmap.find(pu_rid).topology_node
    while node.resource_desc.type.name != "MACHINE":
        node = rmap.find(resource_id_from_string(node.parent_id)).topology_node
    return node.resource_desc.uuid


def test_random_costs_equal_the_jax_package_for_a_seed():
    """RandomCostModel draws utils.rng in the graph manager's arc order:
    the same seed gives every one of a few hundred arcs the same cost
    in both packages, and the same placements."""
    from ksched_tpu.drivers import add_job as jadd_job
    from ksched_tpu.drivers import build_cluster as jbuild
    from ksched_tpu.solver.select import make_backend as jmake
    from ksched_tpu.utils import seed_rng as jseed

    texts, binds = [], []
    for seed_fn, build, add, backend in (
        (seed_rng, build_cluster, add_job, lambda: make_backend("auto", device="cpu")),
        (jseed, jbuild, jadd_job, lambda: jmake("auto", fallback=False)),
    ):
        seed_fn(123)
        sched, rmap, jmap, tmap, root = build(
            num_machines=12, pus_per_core=2, max_tasks_per_pu=4, backend=backend(),
            cost_model_factory=(RandomCostModel if build is build_cluster
                                else jcm.RandomCostModel))
        for _ in range(2):
            add(sched, jmap, tmap, num_tasks=70)
            sched.schedule_all_jobs()
        buf = io.StringIO()
        export(sched.gm.cm.graph, buf)
        texts.append(buf.getvalue())
        binds.append(sorted(sched.get_task_bindings().values()))
    assert texts[0] == texts[1]
    assert texts[0].count("\na ") > 200
    assert binds[0] == binds[1]


def test_random_is_reproducible_under_seed():
    def run():
        seed_rng(123)
        sched, rmap, jmap, tmap, root = _cluster(RandomCostModel)
        add_job(sched, jmap, tmap, num_tasks=4)
        sched.schedule_all_jobs()
        return sorted(sched.get_task_bindings().values())

    assert run() == run()


def test_octopus_balances_load():
    sched, rmap, jmap, tmap, root = _cluster(OctopusCostModel, machines=4, pus=2)
    n = 0
    for _ in range(4):
        add_job(sched, jmap, tmap, num_tasks=1)
        placed, _ = sched.schedule_all_jobs()
        n += placed
    assert n == 4
    per_machine = {}
    for t, pu_rid in sched.get_task_bindings().items():
        m = _machine_of(rmap, pu_rid)
        per_machine[m] = per_machine.get(m, 0) + 1
    assert max(per_machine.values()) == 1, f"octopus packed: {per_machine}"


def test_sjf_prioritizes_short_jobs_under_contention():
    sched, rmap, jmap, tmap, root = _cluster(SjfCostModel, machines=1, pus=2)
    short_job = add_job(sched, jmap, tmap, num_tasks=2)
    long_job = add_job(sched, jmap, tmap, num_tasks=2)
    model = sched.cost_model
    model.record_completion(str(short_job), 10.0)
    model.record_completion(str(long_job), 9000.0)
    n, _ = sched.schedule_all_jobs()
    assert n == 2
    placed = set(sched.get_task_bindings().keys())
    assert placed == {t for t, td in tmap.items() if td.job_id == str(short_job)}


def test_net_gates_machines_without_bandwidth():
    sched, rmap, jmap, tmap, root = _cluster(NetCostModel, machines=2, pus=2)
    machines = list(sched.cost_model._machines.keys())
    rmap.find(machines[0]).descriptor.capacity.net_bw = 1
    rmap.find(machines[1]).descriptor.capacity.net_bw = 100
    job = add_job(sched, jmap, tmap, num_tasks=2)
    for t, td in tmap.items():
        if td.job_id == str(job):
            td.resource_request.net_bw = 40
    n, _ = sched.schedule_all_jobs()
    assert n == 2
    for t, pu_rid in sched.get_task_bindings().items():
        assert resource_id_from_string(_machine_of(rmap, pu_rid)) == machines[1]


def test_net_leaves_unfittable_task_unscheduled():
    sched, rmap, jmap, tmap, root = _cluster(NetCostModel, machines=2, pus=2)
    for m in sched.cost_model._machines:
        rmap.find(m).descriptor.capacity.net_bw = 10
    job = add_job(sched, jmap, tmap, num_tasks=1)
    for t, td in tmap.items():
        if td.job_id == str(job):
            td.resource_request.net_bw = 50
    n, _ = sched.schedule_all_jobs()
    assert n == 0 and sched.get_task_bindings() == {}


def test_void_keeps_supply_conserved():
    sched, rmap, jmap, tmap, root = _cluster(VoidCostModel)
    add_job(sched, jmap, tmap, num_tasks=3)
    sched.schedule_all_jobs()
    assert sched.gm.sink_node.excess == -len(sched.gm.task_to_node)
