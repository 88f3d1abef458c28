"""Cost-model core of the port: graphs, fleets, placements, the float64
oracle (copies of ``repro.core``), the batched torch twin, the §3.1
objective sets, the placement problems with their discrete optimizers,
and the smoothed model with ``projected_gradient``."""

from repro_torch.core.costmodel import (CostConfig, device_occupancy,
                                        edge_latencies, edge_latency,
                                        enabled_links, latency,
                                        latency_via_paths, network_movement,
                                        objective_F)
from repro_torch.core.devices import ExplicitFleet, RegionFleet, \
    RegionFleetFamily
from repro_torch.core.graph import (Operator, OpGraph, diamond_graph,
                                    linear_graph, random_dag)
from repro_torch.core.objectives import (OBJECTIVES, ObjectiveGrids,
                                         ObjectiveSet, ObjectiveSpec,
                                         as_objective_set)
from repro_torch.core.optimizers import (DQCoupling, OptResult,
                                         PlacementProblem, exhaustive_search,
                                         greedy_transfer, random_search,
                                         projected_gradient,
                                         scenario_robust_search,
                                         simulated_annealing)
from repro_torch.core.placement import (random_placement, uniform_placement,
                                        validate_placement)
from repro_torch.core.torchmodel import (SmoothConfig, make_latency_fn,
                                         make_objective_fn)

__all__ = [
    "CostConfig", "device_occupancy", "edge_latencies", "edge_latency",
    "enabled_links", "latency", "latency_via_paths", "network_movement",
    "objective_F",
    "OBJECTIVES", "ObjectiveGrids", "ObjectiveSet", "ObjectiveSpec",
    "as_objective_set",
    "ExplicitFleet", "RegionFleet", "RegionFleetFamily",
    "Operator", "OpGraph", "diamond_graph", "linear_graph", "random_dag",
    "DQCoupling", "OptResult", "PlacementProblem", "exhaustive_search",
    "greedy_transfer", "projected_gradient", "random_search",
    "scenario_robust_search", "simulated_annealing", "SmoothConfig",
    "make_latency_fn", "make_objective_fn", "random_placement", "uniform_placement",
    "validate_placement",
]
