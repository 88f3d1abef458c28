"""Batched search on the port: candidates → batched scoring → decision
(the port of ``repro.search``; see ``src/repro/search/README.md`` for the
layer diagram).

Layer 1 (:mod:`repro_torch.search.candidates`) emits *batches* of
(placement, dq) proposals; Layer 2 (:mod:`repro_torch.search.engine`)
scores each batch through ``BatchedEvaluator.score_grid`` in one dispatch
per chunk — K1 (dense fleets) or K2 (region fleets) on the card; Layer 3
(:mod:`repro_torch.search.decision`, :mod:`repro_torch.search.robust`)
turns grids into choices.  The searchers
(:mod:`repro_torch.search.searchers`) are re-exported by
``repro_torch.core.optimizers`` and the robust searches by
``repro_torch.sim.replay``; :func:`belief_robust_search` draws its scenario
family from a belief posterior (:mod:`repro_torch.belief`).
"""

from repro_torch.search.candidates import (anneal_path, chunked,
                                           count_grid_states, dq_grid,
                                           grid_placements,
                                           incumbent_candidates,
                                           probe_candidates,
                                           random_placements,
                                           transfer_neighborhood)
from repro_torch.search.decision import (ObjectiveScales, ParetoFront,
                                         candidate_values, dq_caps_mask,
                                         epsilon_constraint, joint_dq_scores,
                                         pareto_front, pareto_mask,
                                         robust_select, scalarize,
                                         split_dq_term)
from repro_torch.search.engine import BatchedProblem
from repro_torch.search.robust import (belief_robust_search,
                                       belief_scenarios, robust_placement,
                                       scenario_robust_search)
from repro_torch.search.searchers import (exhaustive_search, greedy_transfer,
                                          random_search, simulated_annealing)

__all__ = [
    # layer 1 — candidates
    "anneal_path", "chunked", "count_grid_states", "dq_grid",
    "grid_placements", "incumbent_candidates", "probe_candidates",
    "random_placements", "transfer_neighborhood",
    # layer 2 — batched scoring
    "BatchedProblem",
    # layer 3 — decision
    "ObjectiveScales", "ParetoFront", "candidate_values", "dq_caps_mask",
    "epsilon_constraint", "joint_dq_scores", "pareto_front", "pareto_mask",
    "robust_select", "scalarize", "split_dq_term",
    "belief_robust_search", "belief_scenarios", "robust_placement",
    "scenario_robust_search",
    # searchers
    "exhaustive_search", "greedy_transfer", "random_search",
    "simulated_annealing",
]
