from .hardware import (A40, A40_CAPPED, HardwareTier, NodeCostModel,
                       ServedModelProfile)
from .simulator import ClusterSimulator, SimNode
from .deployment import build_cluster, paper_deployment
from .elastic import Autoscaler, AutoscalerConfig
