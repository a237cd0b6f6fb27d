from .base import CLUSTER_AGGREGATOR_EC, Cost, CostModeler, CostModelType
from .census import CLASS_ECS, NUM_TASK_CLASSES, ClassCensusKeeper, class_ec, ec_class
from .quincy import BlockRegistry, QuincyCostModel
from .trivial import TrivialCostModel
from .whare import WhareMapCostModel, whare_cost_matrix

#: CostModelType -> implementation, for the models ported so far
MODEL_REGISTRY = {
    CostModelType.TRIVIAL: TrivialCostModel,
    CostModelType.QUINCY: QuincyCostModel,
    CostModelType.WHARE: WhareMapCostModel,
}

__all__ = [
    "BlockRegistry",
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
    "QuincyCostModel",
    "TrivialCostModel",
    "WhareMapCostModel",
    "whare_cost_matrix",
]
