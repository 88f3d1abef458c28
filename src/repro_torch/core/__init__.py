"""Cost-model core of the port: graphs, fleets, placements, the float64
oracle (copies of ``repro.core``) and the batched torch twin."""

from repro_torch.core.costmodel import (CostConfig, edge_latencies,
                                        edge_latency, latency, objective_F)
from repro_torch.core.devices import ExplicitFleet, RegionFleet, \
    RegionFleetFamily
from repro_torch.core.graph import Operator, OpGraph, random_dag
from repro_torch.core.placement import random_placement

__all__ = ["CostConfig", "edge_latencies", "edge_latency", "latency",
           "objective_F", "ExplicitFleet", "RegionFleet",
           "RegionFleetFamily", "Operator", "OpGraph", "random_dag",
           "random_placement"]
