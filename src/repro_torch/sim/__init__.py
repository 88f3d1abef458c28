"""Batched (scenario × placement) evaluation on PyTorch."""

from repro_torch.sim.batched import (BatchedEvaluator, pack_fleets,
                                     pack_placements, pack_region_fleets,
                                     pack_speeds)
from repro_torch.sim.execache import (ExecutableCache, executable_cache,
                                      fresh_cache, graph_key)

__all__ = ["BatchedEvaluator", "pack_fleets", "pack_placements",
           "pack_region_fleets", "pack_speeds", "ExecutableCache",
           "executable_cache", "fresh_cache", "graph_key"]
