"""Min–max robust search over scenario families — the port of
``repro.search.robust`` (``repro_torch.sim.replay`` re-exports these names).

:func:`robust_placement` scores P candidates × S scenarios in one
``score_grid`` dispatch (structured RegionFleetFamily packing when the
fleets share a region layout — 10⁵-device families never materialize an
(S, V, V) tensor; K2 on the card, once per scenario; dense fleets take K1)
and picks the candidate minimizing the worst-case score.

:func:`scenario_robust_search` wraps it with per-scenario greedy warm
starts and exact-oracle re-scoring, and can CO-OPTIMIZE ``dq_fraction``
jointly with the placement (``co_optimize_dq=True``): the raw latency grid
is dispatched once, the (S, P, D) dq expansion is analytic
(:func:`repro_torch.search.decision.joint_dq_scores`), DQCoupling caps mask
infeasible (candidate, dq) pairs, and every scenario keeps its own best
quality knob.

:func:`belief_robust_search` draws the scenario family from a belief
posterior (:func:`belief_scenarios`): the believed fleet plus
posterior-sampled slowdowns, dense ``ExplicitFleet`` copies, so its grid
takes K1 once per scenario.

``device`` takes the place of the reference's ``use_pallas``: ``None`` is
the card, ``"cpu"`` runs the kernels' plain versions.  The grids come back
to the host once per dispatch and every decision is numpy.
"""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.costmodel import CostConfig, latency, objective_F
from repro_torch.core.devices import RegionFleet, RegionFleetFamily
from repro_torch.core.graph import OpGraph
from repro_torch.core.objectives import ObjectiveSet, as_objective_set
from repro_torch.core.placement import random_placement, uniform_placement
from repro_torch.search.decision import (dq_caps_mask, joint_dq_scores,
                                         robust_select, split_dq_term)
from repro_torch.sim.batched import (BatchedEvaluator, pack_fleets,
                                     pack_placements, pack_region_fleets,
                                     pack_speeds)

__all__ = ["belief_robust_search", "belief_scenarios", "robust_placement",
           "scenario_robust_search"]


# above this many bytes of stacked float64 com matrices the dense fallback
# would run out of memory long before producing a useful error — refuse it
_DENSE_FALLBACK_MAX_BYTES = 2 ** 31


def _pack_scenario_fleets(scenarios):
    """Structured pack (RegionFleetFamily) when every fleet shares one
    region layout, dense (S, V, V) stack otherwise — the evaluator
    dispatches on the result's type."""
    fleets = [s.fleet for s in scenarios]
    if all(isinstance(f, RegionFleet) for f in fleets):
        try:
            return pack_region_fleets(fleets)
        except ValueError as e:
            # heterogeneous layouts — dense is the only stack left; at the
            # fleet sizes the structured path exists for, say so instead of
            # dying in an (S, V, V) allocation
            v = fleets[0].n_devices
            dense_bytes = len(fleets) * v * v * 8
            if dense_bytes > _DENSE_FALLBACK_MAX_BYTES:
                raise ValueError(
                    f"scenario fleets do not stack structurally ({e}); the "
                    f"dense fallback would materialize ~{dense_bytes / 1e9:.1f}"
                    f" GB of (S, V, V) com matrices — align the region "
                    f"layouts (e.g. region_scenario_batch) to stay on the "
                    f"structured path") from e
            warnings.warn(
                f"scenario fleets do not stack structurally ({e}); "
                f"falling back to the dense (S, V, V) path", RuntimeWarning,
                stacklevel=4)
    return pack_fleets(fleets)


def _candidates(graph: OpGraph, n_dev: int, rng: np.random.Generator,
                n_candidates: int, sparsity: float,
                extra: list[np.ndarray] | None) -> list[np.ndarray]:
    avail = np.ones((graph.n_ops, n_dev), dtype=bool)
    out = [uniform_placement(graph.n_ops, avail)]
    out += [random_placement(graph.n_ops, avail, rng, sparsity)
            for _ in range(max(n_candidates - 1, 0))]
    if extra:
        out += [np.asarray(x) for x in extra]
    return out


def _score(graph: OpGraph, cfg: CostConfig, scenarios, candidates, dq,
           beta: float, objectives, device):
    """ONE score_grid dispatch of candidates × scenarios, back on the host:
    the (S, P) latency-F grid, or the host ObjectiveGrids."""
    ev = BatchedEvaluator.shared(graph, cfg, device=device)
    pack = _pack_scenario_fleets(scenarios)
    if objectives is None:
        return ev.score_grid(pack_placements(candidates), pack, dq=dq,
                             beta=beta).cpu().numpy()
    # on the dense path the fleets' effective speeds ride alongside the com
    # stack so the occupancy objectives see stragglers
    speed = None if isinstance(pack, RegionFleetFamily) \
        else pack_speeds([s.fleet for s in scenarios])
    return ev.score_grid(pack_placements(candidates), pack, dq=dq,
                         beta=beta, objectives=objectives,
                         speed=speed).to_host()


def robust_placement(graph: OpGraph, scenarios, rng: np.random.Generator,
                     n_candidates: int = 256,
                     cfg: CostConfig = CostConfig(), beta: float = 0.0,
                     dq: float | np.ndarray = 0.0, sparsity: float = 0.5,
                     extra_candidates: list[np.ndarray] | None = None,
                     device=None,
                     objectives: ObjectiveSet | None = None):
    """Min–max what-if selection: the placement minimizing the worst-case
    score over the scenario batch.

    Scenario batches of RegionFleets sharing one region layout (e.g.
    ``region_scenario_batch``) are scored on the structured path — no
    (S, V, V) com stack, so the family can hold 10⁵-device fleets.  ``dq``
    may be a scalar or per-scenario ``(S,)`` (scenario s's quality knob
    divides its row of the grid).

    ``objectives=None`` scores F alone (paper eq. 8); an ObjectiveSet makes
    the score the weighted §3.1 scalarization — every objective's grid and
    the weighted sum still come from ONE dispatch.

    Returns ``(x_best, worst_score, grid)`` where grid is the full (S, P)
    host score matrix (the weighted scalarization when multi-objective)."""
    if not scenarios:
        raise ValueError("need at least one scenario")
    candidates = _candidates(graph, scenarios[0].n_devices, rng,
                             n_candidates, sparsity, extra_candidates)
    res = _score(graph, cfg, scenarios, candidates, dq, beta, objectives,
                 device)
    grid = res if objectives is None else res.scalarized           # (S, P)
    k, worst = robust_select(grid)
    return candidates[k], float(worst[k]), grid


def _joint_robust_placement(graph: OpGraph, scenarios,
                            candidates: list[np.ndarray],
                            cfg: CostConfig, beta: float,
                            dq_values: np.ndarray, dq_coupling,
                            objectives: ObjectiveSet | None,
                            device=None):
    """Joint (placement × dq) min–max: ONE raw dispatch at dq = 0, then the
    analytic per-scenario dq expansion.  Returns
    ``(x_best, worst, scores (S, P), dq_sel (S,) for the winner)``."""
    raw = _score(graph, cfg, scenarios, candidates, 0.0, 0.0, objectives,
                 device)
    lat, rest, w_lat = split_dq_term(raw)
    feasible = dq_caps_mask(np.stack([np.asarray(x) for x in candidates]),
                            dq_values, dq_coupling)
    scores, dq_idx = joint_dq_scores(lat, dq_values, beta, rest=rest,
                                     w_lat=w_lat, feasible=feasible)
    k, worst = robust_select(scores)
    return candidates[k], float(worst[k]), scores, dq_values[dq_idx[:, k]]


def belief_scenarios(belief, base_fleet, rng: np.random.Generator,
                     n_scenarios: int, graph: OpGraph | None = None,
                     beta: float = 0.0) -> list:
    """Scenario batch drawn from a belief posterior
    (:class:`repro_torch.belief.BeliefState`): scenario 0 is the believed
    fleet itself (the posterior mode must stay in the min–max so belief
    sampling can never score WORSE than point-estimate search on the
    belief's own world), scenarios 1..n−1 apply posterior-sampled
    per-device slowdowns.

    This replaces fixed-jitter ``perturbed_fleet`` copies: a well-observed
    device barely varies across the batch while a never-observed one swings
    with its full prior spread — the min–max hedges exactly where the
    belief is actually uncertain."""
    from repro_torch.sim.scenarios import Scenario

    fleets = [base_fleet]
    if n_scenarios > 1:
        fleets += belief.sample_fleets(base_fleet, rng, n_scenarios - 1)
    return [Scenario(name=f"belief{k}", graph=graph, fleet=f, trace=[],
                     beta=beta) for k, f in enumerate(fleets)]


def belief_robust_search(graph: OpGraph, belief, base_fleet,
                         rng: np.random.Generator, n_scenarios: int = 4,
                         **kwargs):
    """:func:`scenario_robust_search` with the scenario family sampled from
    a belief posterior instead of supplied — min–max robust selection whose
    hedging budget follows the posterior variance.  ``kwargs`` pass through
    (n_candidates, beta, objectives, co_optimize_dq, device, ...)."""
    scenarios = belief_scenarios(belief, base_fleet, rng, n_scenarios,
                                 graph=graph,
                                 beta=float(kwargs.get("beta", 0.0)))
    return scenario_robust_search(graph, scenarios, rng, **kwargs)


def scenario_robust_search(graph: OpGraph, scenarios,
                           rng: np.random.Generator, n_candidates: int = 512,
                           cost_cfg: CostConfig = CostConfig(),
                           beta: float = 0.0,
                           dq: float | np.ndarray = 0.0,
                           sparsity: float = 0.5, warm_start: bool = True,
                           objectives: ObjectiveSet | None = None,
                           co_optimize_dq: bool = False, dq_steps: int = 5,
                           dq_coupling=None, device=None):
    """Optimizer-grade wrapper around :func:`robust_placement`.

    Random candidates are scored against every scenario fleet in one
    batched dispatch (structured when the fleets share a region layout);
    ``warm_start`` additionally seeds per-scenario greedy optima (each
    scenario's best placement competes for the min–max crown).

    ``dq`` may be a scalar or a per-scenario ``(S,)`` array.  The returned
    OptResult's F/latency/dq_fraction are for the worst-case scenario of
    the winning placement, recomputed with the exact oracle — the scenario
    maximizing the score (**F**, not latency: with per-scenario dq the
    (1 + β·dq_s) denominators differ).

    With an ``objectives`` ObjectiveSet the whole loop goes multi-objective:
    warm-start greedy seeds descend the weighted scalarization, the grid is
    the scalarized (S, P) matrix, and the reported F is the worst-case
    scenario's scalarized score.

    ``co_optimize_dq=True`` searches the dq grid (``dq_steps`` intervals,
    always containing the incumbent ``dq`` values) JOINTLY with the
    placement, per scenario: the raw grid is still one dispatch, each
    (scenario, candidate) cell keeps its best feasible quality knob
    (``dq_coupling`` — a :class:`repro_torch.core.optimizers.DQCoupling` —
    masks (candidate, dq) pairs whose caps are violated), and the min–max
    runs on the co-optimized scores.

    Also reachable as ``repro_torch.core.scenario_robust_search`` and
    ``repro_torch.sim.replay.scenario_robust_search``.
    """
    from repro_torch.core.optimizers import (OptResult, PlacementProblem,
                                             greedy_transfer)
    from repro_torch.search.candidates import dq_grid as make_dq_grid

    obj_set = None if objectives is None else as_objective_set(objectives)
    dq_s = np.broadcast_to(np.asarray(dq, dtype=np.float64),
                           (len(scenarios),))
    extra, n_dispatches = [], 1   # the robust grid itself is ONE dispatch
    if warm_start:
        for s in scenarios[: min(len(scenarios), 4)]:
            prob = PlacementProblem(graph, s.fleet, cost_cfg, beta=beta,
                                    dq=dq_coupling if co_optimize_dq else None,
                                    objectives=obj_set)
            seed = greedy_transfer(prob, max_rounds=10, device=device)
            extra.append(seed.x)
            n_dispatches += seed.dispatches
    if co_optimize_dq:
        candidates = _candidates(graph, scenarios[0].n_devices, rng,
                                 n_candidates, sparsity, extra)
        dq_values = make_dq_grid(beta, steps=dq_steps, include=tuple(dq_s))
        x, worst_F, grid, dq_sel = _joint_robust_placement(
            graph, scenarios, candidates, cost_cfg, beta, dq_values,
            dq_coupling, obj_set, device=device)
        dq_s = dq_sel
        n_evals = int(grid.size) * dq_values.size
    else:
        x, worst_F, grid = robust_placement(
            graph, scenarios, rng, n_candidates=n_candidates, cfg=cost_cfg,
            beta=beta, dq=dq_s, sparsity=sparsity, extra_candidates=extra,
            device=device, objectives=obj_set)
        n_evals = int(np.asarray(grid).size)
    # worst-case scenario of the winner via the exact oracle (independent of
    # the grid's candidate ordering), picked by the scenario score so
    # per-scenario dq denominators participate in the max
    lats = [latency(graph, s.fleet, x, cost_cfg) for s in scenarios]
    if obj_set is None:
        fs = [objective_F(lat, float(d), beta) for lat, d in zip(lats, dq_s)]
    else:
        fs = [obj_set.scalar_total(graph, s.fleet, x, float(d), beta,
                                   cost_cfg)
              for s, d in zip(scenarios, dq_s)]
    k = int(np.argmax(fs))
    return OptResult(x=x, dq_fraction=float(dq_s[k]), F=fs[k],
                     latency=lats[k], history=[worst_F], evals=n_evals,
                     dispatches=n_dispatches)
