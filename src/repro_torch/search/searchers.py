"""Batched searchers: the seed's scalar-loop optimizers rebuilt on the
three-layer search stack (candidates → batched scoring → decision).

The port of ``repro.search.searchers``.  Signatures and semantics match
the reference (``repro_torch.core.optimizers`` re-exports these), plus
``device=`` for the engine a searcher builds (``None`` is the card).  Every
candidate batch is scored through ``BatchedProblem.score_batch`` (one
``score_grid`` dispatch per chunk) instead of one ``prob.score`` call per
candidate; the decisions are numpy on the host (first-occurrence
``np.argmin``, as in the reference):

  * :func:`exhaustive_search`   — streams the composition grid in chunks;
    same enumeration order and tie-breaking as the seed loop, O(states /
    chunk) dispatches.
  * :func:`greedy_transfer`     — the seed's per-operator move scan, but
    each operator's whole (u → v) transfer neighborhood is one dispatch;
    the selected move is confirmed against the float64 oracle before it is
    applied, so float32 batch noise can't walk the descent.  The DQ grid is
    co-scanned each round and ALWAYS contains the incumbent dq (``dq0``).
  * :func:`simulated_annealing` — block SA: each dispatch scores a
    cumulative random-walk path of proposals from the incumbent, then
    Metropolis-walks it (up to ``block`` accepted moves per dispatch).
    Same move kernel, O(steps / block) dispatches.
  * :func:`random_search`       — random restarts × the full DQ grid in
    chunked dispatches; joint (placement × dq) selection is analytic.

All searchers co-optimize ``dq_fraction`` jointly with the placement
(DQCoupling-aware: infeasible (candidate, dq) pairs score +inf), honor
``prob.objectives`` for multi-objective scalarized search — including
:func:`random_search`, which the seed scored by latency-F only — and
re-score the winner through the exact float64 oracle (``OptResult.of``).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.optimizers import OptResult, PlacementProblem, _dq_grid
from repro_torch.core.placement import (project_with_caps, random_placement,
                                  uniform_placement)
from repro_torch.search.candidates import (anneal_path, chunked,
                                     count_grid_states, grid_placements,
                                     random_placements, transfer_neighborhood)
from repro_torch.search.engine import BatchedProblem

__all__ = [
    "exhaustive_search",
    "greedy_transfer",
    "simulated_annealing",
    "random_search",
]


def _engine(prob: PlacementProblem, engine: BatchedProblem | None,
            device=None) -> tuple[BatchedProblem, int, int]:
    """Reuse a caller-provided engine (its fleet pack stays on the device
    across repeated searches on one problem) or build a fresh one on
    ``device``; returns (engine, evals snapshot, dispatches snapshot) so
    the OptResult reports THIS search's counts even on a shared engine."""
    if engine is None:
        engine = BatchedProblem(prob, device=device)
    elif engine.prob is not prob:
        raise ValueError("engine was built for a different PlacementProblem")
    return engine, engine.evals, engine.dispatches


def _start(prob: PlacementProblem, avail: np.ndarray, x0: np.ndarray | None,
           dq: float, rng: np.random.Generator | None = None) -> np.ndarray:
    x = (random_placement(avail.shape[0], avail, rng) if rng is not None
         else uniform_placement(avail.shape[0], avail)) \
        if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    if prob.dq is not None:
        x = project_with_caps(x, prob.dq.caps(dq), avail)
    return x


# -- exhaustive oracle --------------------------------------------------------

def exhaustive_search(prob: PlacementProblem, granularity: int = 4,
                      max_states: int = 2_000_000, chunk: int = 4096,
                      engine: BatchedProblem | None = None,
                      device=None) -> OptResult:
    """Enumerate placements on the grid x_{i,·} ∈ {k/granularity} — the
    discrete oracle the heuristics are tested against.  Exponential state
    count, but O(states / chunk) dispatches."""
    avail = prob.availability()
    n_states = count_grid_states(avail, granularity)
    if n_states > max_states:
        raise ValueError(f"search space {n_states} exceeds "
                         f"max_states={max_states}")
    eng, e0, d0 = _engine(prob, engine, device)
    dqs = _dq_grid(prob)
    best_F, best_x, best_dq = math.inf, None, 0.0
    for xs in chunked(grid_placements(avail, granularity), min(chunk, eng.chunk)):
        scores = eng.score_batch(xs, dqs)
        k = int(np.argmin(scores))
        i, d = divmod(k, scores.shape[1])
        if scores[i, d] < best_F:
            best_F, best_x, best_dq = float(scores[i, d]), xs[i], dqs[d]
    return OptResult.of(prob, best_x, best_dq, [best_F], eng.evals - e0,
                        dispatches=eng.dispatches - d0)


# -- greedy local descent -----------------------------------------------------

def greedy_transfer(prob: PlacementProblem, x0: np.ndarray | None = None,
                    deltas: tuple[float, ...] = (0.4, 0.2, 0.1, 0.05),
                    max_rounds: int = 60, dq0: float = 0.0,
                    engine: BatchedProblem | None = None,
                    device=None) -> OptResult:
    """Move δ mass between device pairs while it improves exact F.

    Deterministic bottleneck chasing, one dispatch per (operator, round):
    operator i's whole transfer neighborhood is scored as a batch, the
    first-occurrence argmin reproduces the scalar loop's (u, v) scan order,
    and the winning move is re-checked with the float64 oracle before being
    applied.  DQ is co-optimized on a grid (including the incumbent
    ``dq0``) at each round."""
    avail = prob.availability()
    n_ops, _ = avail.shape
    dq = float(dq0)
    x = _start(prob, avail, x0, dq)
    eng, e0, d0 = _engine(prob, engine, device)
    best = prob.score(x, dq)
    history, scalar_evals = [best], 1
    for delta in deltas:
        for _ in range(max_rounds):
            improved = False
            for dq_cand in _dq_grid(prob, include=(dq,)):
                f = prob.score(x, dq_cand)
                scalar_evals += 1
                if f < best - 1e-12:
                    best, dq, improved = f, dq_cand, True
            for i in range(n_ops):
                cands = transfer_neighborhood(x, avail, i, delta)
                if not cands.shape[0]:
                    continue
                scores = eng.score_batch(cands, (dq,))[:, 0]
                k = int(np.argmin(scores))
                if scores[k] < best - 1e-12:
                    f = prob.score(cands[k], dq)
                    scalar_evals += 1
                    if f < best - 1e-12:
                        x, best, improved = cands[k], f, True
            history.append(best)
            if not improved:
                break
    return OptResult.of(prob, x, dq, history,
                        eng.evals - e0 + scalar_evals,
                        dispatches=eng.dispatches - d0)


# -- simulated annealing ------------------------------------------------------

def simulated_annealing(prob: PlacementProblem, rng: np.random.Generator,
                        steps: int = 4000, t0: float = 0.5, t1: float = 1e-3,
                        x0: np.ndarray | None = None, block: int = 64,
                        dq0: float = 0.0,
                        engine: BatchedProblem | None = None,
                        device=None) -> OptResult:
    """Block simulated annealing: per dispatch, score a cumulative
    :func:`anneal_path` of ``block`` moves (the seed's move kernel: random
    mass transfers, DQ jumps when β > 0), then Metropolis-WALK the path —
    relative to the current state every path point is a symmetric
    random-walk composite, so up to ``block`` moves are accepted per
    dispatch and the chain length stays bounded by ``steps`` (not the
    dispatch count).  ``steps`` still counts proposals, so the temperature
    schedule is unchanged; dispatches collapse to ⌈steps / block⌉."""
    avail = prob.availability()
    dq = float(dq0)
    x = _start(prob, avail, x0, dq, rng=rng)
    eng, e0, d0 = _engine(prob, engine, device)
    cur = prob.score(x, dq)
    best, best_x, best_dq = cur, x.copy(), dq
    history, consumed = [cur], 0
    while consumed < steps:
        k = min(block, steps - consumed)
        cands, dqs_c = anneal_path(x, dq, avail, rng, k, prob.beta)
        scores = eng.score_pairs(cands, dqs_c)
        accepted_m = -1
        for m in range(k):
            t = t0 * (t1 / t0) ** ((consumed + m) / max(steps - 1, 1))
            f = float(scores[m])
            if math.isfinite(f) and (
                    f < cur
                    or rng.random() < math.exp(-(f - cur) / max(t, 1e-9))):
                x, dq, cur, accepted_m = cands[m], float(dqs_c[m]), f, m
                if cur < best:
                    best, best_x, best_dq = cur, x.copy(), dq
        # end-of-block downhill jump: the walk may have passed the block's
        # best point and then accepted an uphill composite — moving to the
        # argmin is a pure descent step (Metropolis accepts it with
        # probability 1), and it restores the seed's hill-climbing power
        # that pre-generated paths otherwise lose at low temperatures
        j = int(np.argmin(scores))
        if j != accepted_m and math.isfinite(scores[j]) and scores[j] < cur:
            x, dq, cur = cands[j], float(dqs_c[j]), float(scores[j])
            if cur < best:
                best, best_x, best_dq = cur, x.copy(), dq
        consumed += k
        history.append(best)
    return OptResult.of(prob, best_x, best_dq, history,
                        eng.evals - e0 + 1, dispatches=eng.dispatches - d0)


# -- vectorized random search -------------------------------------------------

def random_search(prob: PlacementProblem, rng: np.random.Generator,
                  n_candidates: int = 2048, sparsity: float = 0.5,
                  batch: int = 256,
                  engine: BatchedProblem | None = None,
                  device=None) -> OptResult:
    """Score random placements × the full DQ grid in chunked dispatches.

    Candidate generation consumes the rng stream in the seed's order; the
    joint (placement × dq) grid is expanded analytically after each
    dispatch, and — unlike the seed loop — a multi-objective problem is
    selected on its weighted scalarization, not latency-F alone."""
    avail = prob.availability()
    n_ops, _ = avail.shape
    eng, e0, d0 = _engine(prob, engine, device)
    dqs = _dq_grid(prob)
    best_F, best_x, best_dq = math.inf, None, 0.0
    # seed with the uniform placement — never return something worse
    uni = uniform_placement(n_ops, avail)
    scores_u = eng.score_batch(uni[None], dqs)[0]
    d = int(np.argmin(scores_u))
    if scores_u[d] < best_F:
        best_F, best_x, best_dq = float(scores_u[d]), uni, dqs[d]
    history, done = [], 0
    while done < n_candidates:
        b = min(batch, n_candidates - done)
        xs = random_placements(avail, rng, b, sparsity)
        scores = eng.score_batch(xs, dqs)
        k = int(np.argmin(scores))
        i, d = divmod(k, scores.shape[1])
        if scores[i, d] < best_F:
            best_F, best_x, best_dq = float(scores[i, d]), xs[i], dqs[d]
        history.append(best_F)
        done += b
    if best_x is None:  # all infeasible — fall back to uniform
        best_x, best_dq = uni, 0.0
    return OptResult.of(prob, best_x, best_dq, history, eng.evals - e0,
                        dispatches=eng.dispatches - d0)
