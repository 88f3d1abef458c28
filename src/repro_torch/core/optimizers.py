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

``projected_gradient`` descends the smoothed cost model
(:mod:`repro_torch.core.torchmodel`) with torch autograd, on the card by
default.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.costmodel import CostConfig, latency, objective_F
from repro_torch.core.devices import ExplicitFleet, RegionFleet
from repro_torch.core.graph import OpGraph
from repro_torch.core.objectives import ObjectiveSet, _smooth_cfg
from repro_torch.core.placement import project_with_caps
from repro_torch.core.torchmodel import make_latency_fn
from repro_torch.kernels import dispatch

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


def _adam_step(p, m, v, g, t: int, lr: float):
    """One Adam update of a float32 tensor in the reference's order of
    operations: the moments, their bias corrections, then
    ``p − lr·m̂ / (√v̂ + 1e-8)``.  The square root is taken in float64 and
    rounded once, which is the correctly rounded float32 root XLA computes
    (torch's vectorized CPU ``sqrt`` is not: it differs in the last bit)."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat = m / (1 - 0.9 ** t)
    vhat = v / (1 - 0.999 ** t)
    # float64 on purpose: XLA's correctly rounded float32 root
    root = torch.sqrt(vhat.double()).to(vhat.dtype)  # repro: ignore[dtype-discipline]
    return p - lr * mhat / (root + 1e-8), m, v


def projected_gradient_loss(prob: PlacementProblem, temp: float,
                            cap_penalty: float = 50.0, device=None):
    """``loss(z, w)`` of :func:`projected_gradient` at one temperature, on
    ``device``: the smoothed F of ``x = softmax(z + availability mask)``
    at ``dq = sigmoid(w)`` (0 when β = 0), plus ``cap_penalty`` times the
    squared overflow of the coupling's caps."""
    dev = dispatch.resolve_device(device)
    mask = torch.where(torch.as_tensor(prob.availability(), device=dev),
                       torch.tensor(0.0, device=dev),
                       torch.tensor(-math.inf, device=dev))
    lat_fn = make_latency_fn(
        prob.graph, prob.fleet,
        dataclasses.replace(_smooth_cfg(prob.cost_cfg), temp=temp),
        device=dev)
    beta, caps_cfg = prob.beta, prob.dq
    if caps_cfg is not None:
        cap0, load = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                      device=dev)
                      for a in (caps_cfg.cap0, caps_cfg.load))

    def loss(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = torch.softmax(z + mask, dim=1)
        dq = torch.sigmoid(w) if beta > 0.0 else 0.0
        f = lat_fn(x) / (1.0 + beta * dq)
        if caps_cfg is not None:
            over = torch.clamp(x.sum(dim=0) - (cap0 - dq * load), min=0.0)
            f = f + cap_penalty * torch.sum(over ** 2)
        return f

    return loss


def projected_gradient(prob: PlacementProblem, steps: int = 400,
                       lr: float = 0.05,
                       temps: tuple[float, ...] = (0.1, 0.02, 0.005),
                       cap_penalty: float = 50.0, seed: int = 0,
                       device=None, z0: np.ndarray | None = None) -> OptResult:
    """Beyond-paper optimizer: anneal a logsumexp-smoothed F with Adam on
    softmax logits; availability via −inf mask; caps via quadratic penalty;
    DQ via a sigmoid-parameterized scalar.  Final score is the exact model.

    The loss and its gradient (one ``torch.autograd.grad`` per step) run on
    ``device`` (``None`` → the card) in float32; ``dispatches`` counts
    those steps, steps × len(temps).  The start logits are
    ``0.01·N(0, 1)`` drawn from a ``torch.Generator`` seeded with ``seed``
    — not the reference's ``jax.random`` numbers — unless ``z0``
    (n_ops, V) hands them over.  Everything after the loop (the snap to
    the dq grid, ``project_with_caps``, the exact score) is numpy float64,
    as in the reference."""
    avail = prob.availability()
    n_ops, n_dev = avail.shape
    dev = dispatch.resolve_device(device)
    if z0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        z = 0.01 * torch.randn((n_ops, n_dev), generator=gen, device=dev)
    else:
        z = torch.tensor(np.asarray(z0), dtype=torch.float32, device=dev)
        if z.shape != (n_ops, n_dev):
            raise ValueError(f"z0 has shape {tuple(z.shape)}, want "
                             f"{(n_ops, n_dev)}")
    w = torch.tensor(-1.0, device=dev)  # dq = sigmoid(w); starts low
    history, evals = [], 0
    dispatches = 0  # gradient steps, steps x len(temps)
    for temp in temps:
        loss = projected_gradient_loss(prob, temp, cap_penalty, dev)
        m = (torch.zeros_like(z), torch.zeros_like(w))
        v = (torch.zeros_like(z), torch.zeros_like(w))
        for t in range(1, steps + 1):
            with torch.enable_grad():
                zg, wg = z.requires_grad_(), w.requires_grad_()
                val = loss(zg, wg)
                gz, gw = torch.autograd.grad(val, (zg, wg),
                                             allow_unused=True,
                                             materialize_grads=True)
            evals += 1
            dispatches += 1
            z, mz, vz = _adam_step(z.detach(), m[0], v[0], gz, t, lr)
            w, mw, vw = _adam_step(w.detach(), m[1], v[1], gw, t, lr)
            m, v = (mz, mw), (vz, vw)
            history.append(float(val.detach()))
    with torch.no_grad():
        x = torch.softmax(z.masked_fill(~torch.as_tensor(avail, device=dev),
                                        -math.inf), dim=1)
        x = x.cpu().numpy().astype(np.float64)
        dq_soft = float(torch.sigmoid(w)) if prob.beta > 0.0 else 0.0
    x = x / x.sum(axis=1, keepdims=True)
    # snap to the best feasible dq on the grid — which always includes the
    # relaxed optimum itself (exact, not rounded)
    best_dq, best_f = 0.0, math.inf
    for dq in _dq_grid(prob, steps=10, include=(dq_soft,)):
        if prob.dq is not None:
            xf = project_with_caps(x, prob.dq.caps(dq), avail)
        else:
            xf = x
        f = prob.score(xf, dq)
        evals += 1
        if f < best_f:
            best_f, best_dq, best_x = f, dq, xf
    return OptResult.of(prob, best_x, best_dq, history, evals,
                        dispatches=dispatches)


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
