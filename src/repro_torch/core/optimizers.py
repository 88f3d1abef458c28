"""Placement / configuration optimizers driven by the paper's cost model —
the port of ``repro.core.optimizers``.

The associated placement problems are NP-hard mixed ILPs (paper §2.3.2), so —
like every system the paper surveys — we attack them with heuristics:

  * ``exhaustive_search``   — oracle on tiny discretized instances (tests).
  * ``greedy_transfer``     — deterministic local mass-transfer descent.
  * ``simulated_annealing`` — randomized global search.
  * ``random_search``       — batched scoring of N random placements
    (the "massive parallelism" of the *optimizer* itself).

All optimizers jointly handle the paper's DQ_fraction: quality checks eat
device capacity via :class:`DQCoupling` (caps(dq) = cap0 − dq·load), which is
how the worked example's "DQ=1 forces fraction x_{2,0} off device 0" story
becomes a mechanical constraint.

The discrete searchers live in :mod:`repro_torch.search` (candidates →
batched scoring on the card → decision) and are re-exported here with the
reference's signatures plus ``device=`` (``None`` is the card; ``"cpu"``
runs the kernels' plain versions).  This module keeps the problem
definitions (:class:`PlacementProblem`, :class:`DQCoupling`,
:class:`OptResult`); the imports of the search and sim layers stay
function-local so the dependency arrow (search → sim → core) stays
one-directional.

``projected_gradient`` descends a smoothed cost model with autodiff; its
smoothed model is not ported yet, so it raises (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.costmodel import CostConfig, latency, objective_F
from repro_torch.core.devices import ExplicitFleet, RegionFleet
from repro_torch.core.graph import OpGraph
from repro_torch.core.objectives import ObjectiveSet

__all__ = [
    "DQCoupling",
    "PlacementProblem",
    "OptResult",
    "exhaustive_search",
    "greedy_transfer",
    "simulated_annealing",
    "projected_gradient",
    "random_search",
    "scenario_robust_search",
]

Fleet = ExplicitFleet | RegionFleet


@dataclasses.dataclass(frozen=True)
class DQCoupling:
    """Device capacity as a function of DQ_fraction.

    cap_u(dq) = cap0_u − dq·load_u ; constraint: Σ_i x_{i,u} ≤ cap_u(dq).
    With load=0 the DQ knob is free (latency unaffected — then F strictly
    improves with dq and the optimizer pins dq=1, as eq. 8 dictates).
    """

    cap0: np.ndarray
    load: np.ndarray

    def caps(self, dq: float) -> np.ndarray:
        return np.asarray(self.cap0) - float(dq) * np.asarray(self.load)


@dataclasses.dataclass(frozen=True)
class PlacementProblem:
    """One placement instance.  ``objectives=None`` scores paper eq. (8)'s F
    alone; an :class:`repro_torch.core.objectives.ObjectiveSet` makes
    ``score`` the weighted multi-objective scalarization through the exact
    oracles — every discrete optimizer then minimizes it unchanged."""

    graph: OpGraph
    fleet: Fleet
    cost_cfg: CostConfig = CostConfig()
    beta: float = 0.0
    dq: DQCoupling | None = None
    objectives: ObjectiveSet | None = None

    def availability(self) -> np.ndarray:
        return self.fleet.availability(self.graph.n_ops)

    def feasible(self, x: np.ndarray, dq: float, atol: float = 1e-7) -> bool:
        if self.dq is None:
            return True
        return bool((x.sum(axis=0) <= self.dq.caps(dq) + atol).all())

    def score(self, x: np.ndarray, dq: float = 0.0) -> float:
        """Exact weighted objective (∞ if infeasible); F when single-objective."""
        if not self.feasible(x, dq):
            return math.inf
        if self.objectives is not None:
            return self.objectives.scalar_total(self.graph, self.fleet, x,
                                                dq, self.beta, self.cost_cfg)
        lat = latency(self.graph, self.fleet, x, self.cost_cfg)
        return objective_F(lat, dq, self.beta)


@dataclasses.dataclass
class OptResult:
    """``evals`` counts logical candidate evaluations (the seed's unit);
    ``dispatches`` counts batched dispatches (one ``score_grid`` call each)
    — the batched searchers' O(candidates) → O(dispatches) collapse (0 for
    scalar-loop paths)."""

    x: np.ndarray
    dq_fraction: float
    F: float
    latency: float
    history: list[float]
    evals: int
    dispatches: int = 0

    @classmethod
    def of(cls, prob: PlacementProblem, x: np.ndarray, dq: float,
           history: list[float], evals: int,
           dispatches: int = 0) -> "OptResult":
        """F is the problem's own score: paper eq. (8) single-objective, or
        the weighted scalarization when the problem carries an ObjectiveSet
        (latency stays the raw critical-path latency either way)."""
        lat = latency(prob.graph, prob.fleet, x, prob.cost_cfg)
        f = objective_F(lat, dq, prob.beta) if prob.objectives is None \
            else prob.objectives.scalar_total(prob.graph, prob.fleet, x, dq,
                                              prob.beta, prob.cost_cfg)
        return cls(x=x, dq_fraction=dq, F=f, latency=lat, history=history,
                   evals=evals, dispatches=dispatches)


def _dq_grid(prob: PlacementProblem, steps: int = 5,
             include: tuple[float, ...] = ()) -> list[float]:
    """DQ candidates: {k/steps} when β > 0, else {0} — ALWAYS containing the
    ``include`` values (the search's incumbent dq_fraction, so re-optimizing
    from a previous result can never regress the dq term just because the
    incumbent is not a grid multiple; see
    repro_torch.search.candidates.dq_grid)."""
    from repro_torch.search.candidates import dq_grid

    return list(dq_grid(prob.beta, steps=steps, include=include))


# -- batched discrete searchers (implementations in repro_torch.search) -------

def exhaustive_search(prob: PlacementProblem, granularity: int = 4,
                      max_states: int = 2_000_000,
                      device=None) -> OptResult:
    """Enumerate placements on the grid x_{i,·} ∈ {k/granularity} — the
    discrete oracle the heuristics are tested against.  Exponential state
    count; scored in chunked batched dispatches by
    :func:`repro_torch.search.searchers.exhaustive_search`."""
    from repro_torch.search.searchers import exhaustive_search as impl

    return impl(prob, granularity=granularity, max_states=max_states,
                device=device)


def greedy_transfer(prob: PlacementProblem, x0: np.ndarray | None = None,
                    deltas: tuple[float, ...] = (0.4, 0.2, 0.1, 0.05),
                    max_rounds: int = 60, device=None) -> OptResult:
    """Move δ mass between device pairs while it improves exact F.

    Deterministic, paper-style bottleneck chasing; each operator's whole
    transfer neighborhood is scored as one batched dispatch by
    :func:`repro_torch.search.searchers.greedy_transfer`.  DQ is
    co-optimized on a grid at each δ level."""
    from repro_torch.search.searchers import greedy_transfer as impl

    return impl(prob, x0=x0, deltas=deltas, max_rounds=max_rounds,
                device=device)


def simulated_annealing(prob: PlacementProblem, rng: np.random.Generator,
                        steps: int = 4000, t0: float = 0.5, t1: float = 1e-3,
                        x0: np.ndarray | None = None,
                        device=None) -> OptResult:
    """Randomized global search (block-batched Metropolis; implementation in
    :func:`repro_torch.search.searchers.simulated_annealing`; ``steps``
    still counts proposals)."""
    from repro_torch.search.searchers import simulated_annealing as impl

    return impl(prob, rng, steps=steps, t0=t0, t1=t1, x0=x0, device=device)


def projected_gradient(prob: PlacementProblem, steps: int = 400,
                       lr: float = 0.05,
                       temps: tuple[float, ...] = (0.1, 0.02, 0.005),
                       cap_penalty: float = 50.0, seed: int = 0) -> OptResult:
    """Beyond-paper optimizer of the reference: Adam on softmax logits
    through the logsumexp-smoothed model.  Not ported: the smoothed model
    and its autodiff come with ROADMAP A9."""
    raise NotImplementedError(
        "projected_gradient needs the smoothed cost model and autodiff, "
        "which are not ported yet (ROADMAP A9); use greedy_transfer, "
        "simulated_annealing or random_search")


# -- scenario-robust search (min–max over a generated what-if family) ---------

def scenario_robust_search(graph: OpGraph, scenarios, rng: np.random.Generator,
                           **kwargs) -> OptResult:
    """Placement minimizing WORST-CASE F over a scenario batch.

    Delegator: the implementation lives in
    :func:`repro_torch.search.robust.scenario_robust_search` (reached
    through ``repro_torch.sim.replay``, as in the reference; the import stays
    function-local to keep core importable without sim).
    """
    from repro_torch.sim.replay import scenario_robust_search as impl

    return impl(graph, scenarios, rng, **kwargs)


# -- vectorized random search -------------------------------------------------

def random_search(prob: PlacementProblem, rng: np.random.Generator,
                  n_candidates: int = 2048, sparsity: float = 0.5,
                  batch: int = 256, device=None) -> OptResult:
    """Score many random placements in chunked batched dispatches
    (:func:`repro_torch.search.searchers.random_search`; multi-objective
    problems select on the weighted scalarization)."""
    from repro_torch.search.searchers import random_search as impl

    return impl(prob, rng, n_candidates=n_candidates, sparsity=sparsity,
                batch=batch, device=device)
