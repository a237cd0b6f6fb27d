from .base import CLUSTER_AGGREGATOR_EC, Cost, CostModeler, CostModelType
from .census import CLASS_ECS, NUM_TASK_CLASSES, ClassCensusKeeper, class_ec, ec_class
from .coco import CocoCostModel, coco_cost_matrix
from .net import NetCostModel
from .quincy import BlockRegistry, QuincyCostModel
from .simple import OctopusCostModel, RandomCostModel, SjfCostModel, VoidCostModel
from .trivial import TrivialCostModel
from .whare import WhareMapCostModel, whare_cost_matrix

#: CostModelType -> implementation, the dispatch the reference plans in
#: costmodel/interface.go:33-43 — here every enumerated model exists.
MODEL_REGISTRY = {
    CostModelType.TRIVIAL: TrivialCostModel,
    CostModelType.RANDOM: RandomCostModel,
    CostModelType.SJF: SjfCostModel,
    CostModelType.QUINCY: QuincyCostModel,
    CostModelType.WHARE: WhareMapCostModel,
    CostModelType.COCO: CocoCostModel,
    CostModelType.OCTOPUS: OctopusCostModel,
    CostModelType.VOID: VoidCostModel,
    CostModelType.NET: NetCostModel,
}

__all__ = [
    "CLUSTER_AGGREGATOR_EC",
    "CLASS_ECS",
    "NUM_TASK_CLASSES",
    "ClassCensusKeeper",
    "class_ec",
    "ec_class",
    "Cost",
    "CostModeler",
    "CostModelType",
    "MODEL_REGISTRY",
    "BlockRegistry",
    "CocoCostModel",
    "coco_cost_matrix",
    "NetCostModel",
    "OctopusCostModel",
    "QuincyCostModel",
    "RandomCostModel",
    "SjfCostModel",
    "TrivialCostModel",
    "VoidCostModel",
    "WhareMapCostModel",
    "whare_cost_matrix",
]
