"""Scenario simulation on PyTorch: generated what-if families, batched
(scenario × placement) evaluation (dense or structured RegionFleetFamily),
trace replay and the belief layer's training tuples — the port of
``repro.sim``."""

from repro_torch.sim.batched import (BatchedEvaluator, pack_fleets,
                                     pack_placements, pack_region_fleets,
                                     pack_speeds)
from repro_torch.sim.execache import (ExecutableCache, executable_cache,
                                      fresh_cache, graph_key,
                                      set_executable_cache)
from repro_torch.sim.replay import (ReplayReport, ReplayStep,
                                    apply_fleet_event, replay_trace,
                                    robust_placement, scenario_robust_search)
from repro_torch.sim.scenarios import (MIN_ALIVE_DEVICES, Scenario,
                                       ScenarioConfig, TraceEvent,
                                       diurnal_rate, perturbed_fleet,
                                       random_fleet, random_graph,
                                       random_scenario, random_trace,
                                       region_fleet_family,
                                       region_scenario_batch, scenario_batch)
from repro_torch.sim.training import (TrainingTuples, merge_tuples,
                                      training_tuples)

__all__ = [
    "BatchedEvaluator", "pack_fleets", "pack_placements", "pack_region_fleets",
    "pack_speeds",
    "ExecutableCache", "executable_cache", "fresh_cache", "graph_key",
    "set_executable_cache",
    "ReplayReport", "ReplayStep", "apply_fleet_event", "replay_trace",
    "robust_placement", "scenario_robust_search",
    "MIN_ALIVE_DEVICES", "Scenario", "ScenarioConfig", "TraceEvent",
    "diurnal_rate", "perturbed_fleet", "random_fleet", "random_graph",
    "random_scenario", "random_trace", "region_fleet_family",
    "region_scenario_batch", "scenario_batch",
    "TrainingTuples", "merge_tuples", "training_tuples",
]
