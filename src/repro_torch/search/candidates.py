"""Layer 1 — candidate generation: composable proposal sources that emit
*batches* of (placement, dq) candidates.

The seed optimizers interleaved proposal generation with one-at-a-time
scoring; here every source produces whole (B, n_ops, V) arrays (plus the DQ
grid as an independent axis) so Layer 2 (:mod:`repro_torch.search.engine`) can
score each batch in a single jitted dispatch.  Sources:

  * :func:`grid_placements`        — the exhaustive composition grid
    (``x_{i,·} ∈ {k/granularity}``), streamed lazily so the state count can
    exceed memory as long as it is chunked;
  * :func:`random_placements`      — Dirichlet random restarts;
  * :func:`transfer_neighborhood`  — the greedy δ-mass transfer moves of one
    operator, in the seed's deterministic (u-major, v-minor) order so a
    first-occurrence ``argmin`` over the batch reproduces the scalar loop's
    tie-breaking exactly;
  * :func:`anneal_path`            — a cumulative random-walk block of
    simulated-annealing moves (mass transfers and, when β > 0, DQ jumps)
    for one incumbent, Metropolis-walked after a single dispatch;
  * :func:`probe_candidates`       — deterministic probing variants of an
    incumbent that keep ε placement mass on high-uncertainty devices
    (belief-posterior std from :mod:`repro.belief`), so the controller can
    *buy* observations of devices its placement would otherwise never
    touch;
  * :func:`dq_grid`                — the DQ candidate grid, which ALWAYS
    contains the incumbent ``dq_fraction`` (``include=``): the seed grid
    could regress the DQ term simply because the incumbent value was not a
    multiple of 1/steps.

The joint (placement × dq) cross product is deliberately *not* materialized
here: DQ only enters the objective through the analytic ``/(1 + β·dq)``
factor and the DQCoupling feasibility caps, so Layer 2 expands it after the
dispatch at O(P·D) numpy cost (see ``BatchedProblem.score_batch``).

numpy-only copy of ``repro.search.candidates`` for the PyTorch port (the
belief layer and the adaptive controller named above are the reference's;
the port has them queued).
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "dq_grid",
    "grid_placements",
    "count_grid_states",
    "incumbent_candidates",
    "probe_candidates",
    "random_placements",
    "transfer_neighborhood",
    "anneal_path",
    "chunked",
]


def dq_grid(beta: float, steps: int = 5,
            include: Sequence[float] = ()) -> np.ndarray:
    """DQ_fraction candidates: {k/steps} when β > 0, else {0}, PLUS every
    ``include`` value (clipped to [0, 1]).

    ``include`` carries the search's incumbent dq so a re-optimization
    starting from a previous result can never lose its dq term to grid
    quantization — the values are deduplicated and sorted, so downstream
    first-occurrence argmins stay deterministic."""
    vals = {0.0} if beta == 0.0 else \
        {float(v) for v in np.linspace(0.0, 1.0, steps + 1)}
    vals.update(float(np.clip(v, 0.0, 1.0)) for v in include)
    return np.array(sorted(vals), dtype=np.float64)


def _per_op_rows(avail: np.ndarray, granularity: int) -> list[list[np.ndarray]]:
    """For each operator, every grid row x_{i,·} ∈ {k/granularity} on its
    available devices (the seed's ``_compositions`` enumeration order)."""
    n_ops, n_dev = avail.shape
    out: list[list[np.ndarray]] = []
    for i in range(n_ops):
        idx = np.flatnonzero(avail[i])
        rows = []
        for comp in _compositions(granularity, idx.size):
            row = np.zeros(n_dev)
            row[idx] = np.asarray(comp) / granularity
            rows.append(row)
        out.append(rows)
    return out


def _compositions(total: int, parts: int):
    """All ways to write ``total`` as an ordered sum of ``parts`` ≥0 ints."""
    if parts == 1:
        yield (total,)
        return
    for head in range(total + 1):
        for tail in _compositions(total - head, parts - 1):
            yield (head,) + tail


def count_grid_states(avail: np.ndarray, granularity: int) -> int:
    """Size of the composition grid — the exhaustive searcher's budget check
    (computed without enumerating: C(granularity + k − 1, k − 1) per op)."""
    n = 1
    for i in range(avail.shape[0]):
        k = int(np.flatnonzero(avail[i]).size)
        n *= math.comb(granularity + k - 1, k - 1)
    return n


def grid_placements(avail: np.ndarray,
                    granularity: int) -> Iterator[np.ndarray]:
    """Stream every composition-grid placement in the seed's enumeration
    order (itertools.product over per-op rows).  O(1) memory per state —
    chunk with :func:`chunked` for batched scoring."""
    for rows in itertools.product(*_per_op_rows(avail, granularity)):
        yield np.stack(rows)


def random_placements(avail: np.ndarray, rng: np.random.Generator, n: int,
                      sparsity: float = 0.0) -> np.ndarray:
    """(n, n_ops, V) Dirichlet-random placements (repro_torch.core.placement's
    ``random_placement`` semantics, batched; consumes the rng stream in the
    same per-candidate order as the seed's scalar loop)."""
    from repro_torch.core.placement import random_placement

    n_ops = avail.shape[0]
    return np.stack([random_placement(n_ops, avail, rng, sparsity)
                     for _ in range(n)])


def incumbent_candidates(x: np.ndarray, avail: np.ndarray,
                         rng: np.random.Generator, n: int,
                         jitter: float = 0.25,
                         sparsity: float = 0.5) -> np.ndarray:
    """(n, n_ops, V) warm-start batch around an incumbent placement: the
    incumbent itself FIRST (a re-optimization can therefore never regress —
    first-occurrence argmin keeps it on ties), then ~half jittered copies
    (simplex-renormalized mixtures of the incumbent with Dirichlet noise —
    local moves for drift-chasing re-placement), then Dirichlet random
    restarts (global escapes).  The shape of choice for closed-loop
    re-optimization (:mod:`repro.adapt`), where the previous placement is
    usually nearly right and the search budget is one dispatch."""
    x = np.asarray(x, dtype=np.float64)
    if n < 1:
        raise ValueError(f"need n ≥ 1 candidates, got {n}")
    out = [x]
    n_local = (n - 1 + 1) // 2
    for _ in range(n_local):
        noise = random_placements(avail, rng, 1, 0.0)[0]
        cand = (1.0 - jitter) * x + jitter * noise
        mass = cand.sum(axis=1, keepdims=True)
        out.append(np.divide(cand, mass, out=np.zeros_like(cand),
                             where=mass > 0.0))
    if len(out) < n:
        out.extend(random_placements(avail, rng, n - len(out), sparsity))
    return np.stack(out[:n])


def probe_candidates(x: np.ndarray, avail: np.ndarray,
                     uncertainty: np.ndarray, epsilon: float,
                     top_k: int = 2) -> np.ndarray:
    """(top_k, n_ops, V) probing variants of the incumbent: variant k moves
    ε of every operator's mass onto the k most-uncertain devices (mass
    split ∝ posterior std among them, masked per-op by availability).

    Deterministic — no rng — so probing perturbs neither the controller's
    candidate stream nor reproducibility, and it costs ZERO extra
    dispatches: the variants ride in the same ``score_grid`` batch as the
    incumbent candidates.  A probe is only adopted when the robust
    objective (plus the exploration bonus the controller applies) says the
    information is worth its price.  With ``epsilon <= 0``, no uncertainty
    signal, or nothing available, the batch is empty."""
    x = np.asarray(x, dtype=np.float64)
    std = np.asarray(uncertainty, dtype=np.float64)
    if epsilon <= 0.0 or top_k < 1 or not np.any(std > 0.0):
        return np.empty((0,) + x.shape)
    eps = float(np.clip(epsilon, 0.0, 1.0))
    # most-uncertain devices first; stable sort keeps ties index-ordered
    order = np.argsort(-std, kind="stable")
    out = []
    for k in range(1, top_k + 1):
        chosen = order[:k]
        weights = np.zeros(std.size)
        weights[chosen] = std[chosen]
        # per-op availability mask + renormalization: an op that can run on
        # none of the probe targets keeps its incumbent row
        target = np.asarray(avail, dtype=np.float64) * weights[None, :]
        mass = target.sum(axis=1, keepdims=True)
        target = np.divide(target, mass, out=np.zeros_like(target),
                           where=mass > 0.0)
        movable = mass[:, 0] > 0.0
        cand = x.copy()
        cand[movable] = (1.0 - eps) * x[movable] + eps * target[movable]
        out.append(cand)
    return np.stack(out)


def transfer_neighborhood(x: np.ndarray, avail: np.ndarray, op: int,
                          delta: float) -> np.ndarray:
    """(M, n_ops, V) — every δ-mass transfer of operator ``op`` between its
    available device pairs (u → v, u ≠ v, x[op, u] ≥ δ).

    Emission order is u-major / v-minor, matching the seed greedy's nested
    loop, so ``argmin`` over the scored batch (first occurrence on ties)
    selects the same move the scalar loop would."""
    idx = np.flatnonzero(avail[op])
    moves = [(u, v) for u in idx if x[op, u] >= delta - 1e-12
             for v in idx if v != u]
    if not moves:
        return np.empty((0,) + x.shape)
    out = np.repeat(x[None, :, :], len(moves), axis=0)
    for m, (u, v) in enumerate(moves):
        out[m, op, u] -= delta
        out[m, op, v] += delta
    return out


def anneal_path(x: np.ndarray, dq: float, avail: np.ndarray,
                rng: np.random.Generator, k: int, beta: float,
                dq_move_prob: float = 0.15
                ) -> tuple[np.ndarray, np.ndarray]:
    """A CUMULATIVE random-walk path of ``k`` simulated-annealing moves from
    the incumbent ``(x, dq)``: point m applies one seed-SA move (a random
    mass transfer, or a DQ jump with probability ``dq_move_prob`` when
    β > 0) on top of point m − 1.

    The searcher scores the whole path in one dispatch and Metropolis-walks
    it point by point: relative to the currently-accepted state, every path
    point is a symmetric random-walk composite (the moves were drawn
    independently of the accept/reject decisions), so up to ``k`` moves can
    be accepted per dispatch — the chain length is bounded by ``steps``,
    not by the dispatch count.  Returns
    ``(placements (k, n_ops, V), dqs (k,))``."""
    n_ops = x.shape[0]
    cands = np.empty((k,) + x.shape, dtype=np.float64)
    dqs = np.empty(k, dtype=np.float64)
    cur, cur_dq = x.copy(), float(dq)
    for m in range(k):
        if beta > 0.0 and rng.random() < dq_move_prob:
            cur_dq = float(np.clip(
                cur_dq + rng.choice([-0.2, -0.1, 0.1, 0.2]), 0.0, 1.0))
        else:
            i = rng.integers(n_ops)
            idx = np.flatnonzero(avail[i])
            if idx.size >= 2:
                u, v = rng.choice(idx, size=2, replace=False)
                amt = rng.uniform(0.0, cur[i, u])
                cur[i, u] -= amt
                cur[i, v] += amt
        cands[m] = cur
        dqs[m] = cur_dq
    return cands, dqs


def chunked(it: Iterator[np.ndarray], size: int) -> Iterator[np.ndarray]:
    """Stack a placement stream into (≤size, n_ops, V) batches."""
    block: list[np.ndarray] = []
    for x in it:
        block.append(x)
        if len(block) == size:
            yield np.stack(block)
            block = []
    if block:
        yield np.stack(block)
