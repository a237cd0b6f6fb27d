"""The port's cost models (costmodels/: the nine of MODEL_REGISTRY)
against the JAX package's: every model scheduled end to end through the
service driver (drivers/service.py run_service) in both packages with
the same seed, each round's bound count, placements' sha256, AutoSolver
path and solver work equal, and the flow graph's arc costs equal byte
for byte (its DIMACS export); and CoCo's cost matrix and host model
against the JAX package's (tests/test_interference_models.py). The
policies' signature behaviours: tests/test_torch_policy_behaviour.py.
Tolerance 0."""

import io

import numpy as np
import pytest

from ksched_tpu_torch.costmodels import (
    MODEL_REGISTRY,
    CocoCostModel,
    CostModelType,
    coco_cost_matrix,
)
from ksched_tpu_torch.costmodels.coco import INTERFERENCE, MAX_COST, machine_penalty_matrix
from ksched_tpu_torch.drivers.service import ServiceConfig, package, run_service
from ksched_tpu_torch.graph.dimacs import export
from ksched_tpu_torch.utils import resource_id_from_string

jcm = pytest.importorskip("ksched_tpu.costmodels")
from torch_service_reference import jax_package  # noqa: E402

SMALL = dict(machines=6, pus_per_core=2, slots=4, pods=40, rounds=3, churn=0.1,
             arrivals=8)
KEEP = ("bound", "placed", "path", "solver_work", "sha256")


def test_registry_covers_every_enumerated_model():
    assert set(MODEL_REGISTRY) == set(CostModelType)
    assert {k.name: v.__name__ for k, v in MODEL_REGISTRY.items()} == {
        k.name: v.__name__ for k, v in jcm.MODEL_REGISTRY.items()}


@pytest.mark.parametrize("model", [m.name.lower() for m in CostModelType])
def test_every_model_schedules_as_the_jax_package(model):
    cfg = ServiceConfig(**SMALL, cost_model=model, classes=4 if model == "coco" else 1)
    got = run_service(package("cpu"), cfg)
    want = run_service(jax_package(), cfg)
    rows = [[r[k] for k in KEEP] for r in got["rounds"]]
    assert rows == [[r[k] for k in KEEP] for r in want["rounds"]]
    texts = []
    for out in (got, want):
        buf = io.StringIO()
        export(out["service"].scheduler.gm.cm.graph, buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    if model != "void":
        assert rows[0][0] == SMALL["pods"], rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_cost_matrix_equals_the_jax_package(seed):
    from ksched_tpu.costmodels.coco import coco_cost_matrix as jmatrix

    rng = np.random.default_rng(seed)
    census = rng.integers(0, 300, (50, 4))
    pen = rng.integers(0, 500, (50, 4))
    for args in ((census,), (census, pen)):
        got, want = coco_cost_matrix(*args), jmatrix(*args)
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert coco_cost_matrix(census).max() <= MAX_COST


def test_object_layer_coco_model_costs():
    """CocoCostModel against hand-built resource state, the same costs
    and capacities as the JAX package's model on the same state."""
    from ksched_tpu.costmodels.coco import CocoCostModel as JaxCoco
    from ksched_tpu.data import ResourceDescriptor as JRD
    from ksched_tpu.data import ResourceTopologyNodeDescriptor as JRTND
    from ksched_tpu.data import ResourceType as JRType
    from ksched_tpu.data import TaskDescriptor as JTD
    from ksched_tpu.data import TaskType as JTType
    from ksched_tpu.utils import ResourceMap as JRMap
    from ksched_tpu.utils import ResourceStatus as JRS
    from ksched_tpu.utils import TaskMap as JTMap

    from ksched_tpu_torch.costmodels import CLASS_ECS
    from ksched_tpu_torch.data import (
        ResourceDescriptor,
        ResourceTopologyNodeDescriptor,
        ResourceType,
        TaskDescriptor,
        TaskType,
    )
    from ksched_tpu_torch.utils import ResourceMap, ResourceStatus, TaskMap

    def build(model_cls, RD, RTND, RType, TD, TType, RMap, RS, TMap):
        rmap, tmap = RMap(), TMap()
        model = model_cls(rmap, tmap, set(), 4)
        rd = RD(uuid="41", type=RType.MACHINE)
        rd.num_slots_below = 8
        rd.num_running_tasks_below = 2
        rd.whare_map_stats.num_devils = 2
        rd.coco_interference_scores.sheep_penalty = 5
        rtnd = RTND(resource_desc=rd)
        rid = resource_id_from_string("41")
        rmap.insert(rid, RS(rd, rtnd, "", 0))
        model.add_machine(rtnd)
        tmap.insert(7, TD(uid=7, task_type=TType.RABBIT))
        tmap.insert(8, TD(uid=8, task_type=TType.SHEEP))
        return model, rid

    mine, rid = build(CocoCostModel, ResourceDescriptor, ResourceTopologyNodeDescriptor,
                      ResourceType, TaskDescriptor, TaskType, ResourceMap, ResourceStatus,
                      TaskMap)
    ref, _ = build(JaxCoco, JRD, JRTND, JRType, JTD, JTType, JRMap, JRS, JTMap)
    rabbit_ec = CLASS_ECS[int(TaskType.RABBIT)]
    cost, cap = mine.equiv_class_to_resource_node(rabbit_ec, rid)
    assert cap == 6
    assert cost == int(INTERFERENCE[int(TaskType.RABBIT), int(TaskType.DEVIL)]) * 2
    assert mine.get_task_equiv_classes(7) == [rabbit_ec]
    assert mine.task_to_unscheduled_agg_cost(7) > MAX_COST
    for ec in CLASS_ECS:
        assert mine.equiv_class_to_resource_node(ec, rid) == ref.equiv_class_to_resource_node(ec, rid)
    for t in (7, 8):
        assert mine.task_to_resource_node_cost(t, rid) == ref.task_to_resource_node_cost(t, rid)
        assert mine.get_task_equiv_classes(t) == ref.get_task_equiv_classes(t)
    assert mine.task_preemption_cost(7) == ref.task_preemption_cost(7)
