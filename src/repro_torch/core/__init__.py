"""Cost-model core of the port: graphs, fleets, placements, the float64
oracle (copies of ``repro.core``), the batched torch twin and the §3.1
objective sets."""

from repro_torch.core.costmodel import (CostConfig, device_occupancy,
                                        edge_latencies, edge_latency,
                                        latency, network_movement,
                                        objective_F)
from repro_torch.core.devices import ExplicitFleet, RegionFleet, \
    RegionFleetFamily
from repro_torch.core.graph import Operator, OpGraph, random_dag
from repro_torch.core.objectives import (OBJECTIVES, ObjectiveGrids,
                                         ObjectiveSet, ObjectiveSpec,
                                         as_objective_set)
from repro_torch.core.placement import random_placement

__all__ = ["CostConfig", "device_occupancy", "edge_latencies",
           "edge_latency", "latency", "network_movement", "objective_F", "ExplicitFleet", "RegionFleet",
           "RegionFleetFamily", "Operator", "OpGraph", "random_dag",
           "random_placement", "OBJECTIVES", "ObjectiveGrids", "ObjectiveSet",
           "ObjectiveSpec", "as_objective_set"]
