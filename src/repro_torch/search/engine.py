"""Layer 2 — batched scoring: every candidate batch goes through
``BatchedEvaluator.score_grid`` in O(dispatches), not O(candidates) — the
port of ``repro.search.engine``.

:class:`BatchedProblem` wraps one :class:`repro_torch.core.optimizers.
PlacementProblem` and exposes ``score_batch(placements, dqs) -> (P, D)``
— the exact quantity ``prob.score`` returns, for a whole candidate batch
crossed with a whole DQ grid, from ONE ``score_grid`` dispatch per chunk:

  * the fleet is packed once, on the evaluator's device — an ExplicitFleet
    as a (1, V, V) float32 com tensor held for the problem's lifetime (K1
    on the card), a RegionFleet as an S=1 :class:`RegionFleetFamily` (K2),
    so 10⁵-device problems never materialize V×V;
  * the evaluator scores the batch at dq = 0 (raw latency / raw objective
    grids); DQ only enters through the analytic ``/(1 + β·dq)`` factor on
    the latency-F term, so the (P, D) joint grid is expanded AFTER the
    dispatch at numpy cost — ``dq_fraction`` becomes a free search
    dimension;
  * DQCoupling feasibility (caps(dq) = cap0 − dq·load ≥ column mass) is a
    vectorized (P, D) mask applied as +inf, mirroring ``prob.score``'s
    infeasible-⇒-inf convention;
  * multi-objective problems split the scalarization into the latency-F
    term (dq-dependent) and the rest (dq-independent), both from the same
    ``ObjectiveSet`` dispatch.

Candidate batches are padded to power-of-two buckets (padding repeats the
first row), as in the reference, so chunk shapes stay few.  The
reference meters a retrace budget on the first dispatch of each bucket
(``sanitize.note_first_dispatch``); eager PyTorch does not retrace, so the
port keeps the ``search.bucket_first_dispatch`` counter and has no budget.

Scoring is float32 on the batched path (the evaluator's precision); the
searchers re-score their winners through the float64 oracle before
reporting.  Every score comes back to the host as numpy, so the searchers'
first-occurrence ``np.argmin`` is the reference's tie-breaking.

Problems with ``cfg.include_compute`` fall back to a scalar ``prob.score``
loop — the batched evaluator covers the paper-faithful model only — decided
BEFORE any evaluator or device is resolved, so the StreamingEngine's
re-optimization runs without a card and issues no dispatch.

``device`` takes the place of the reference's ``use_pallas``: ``None`` is
the card (and raises without CUDA), ``"cpu"`` runs the kernels' plain
versions; a given ``evaluator`` brings its own device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.core.devices import ExplicitFleet, RegionFleet, \
    RegionFleetFamily
from repro_torch.core.optimizers import PlacementProblem
from repro_torch.kernels import dispatch
from repro_torch.search.decision import dq_caps_mask, split_dq_term
from repro_torch.sim.batched import BatchedEvaluator

__all__ = ["BatchedProblem"]


def _bucket(n: int) -> int:
    """Next power of two — candidate batches are padded up to buckets so
    varying neighborhood sizes reuse a few shapes."""
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class BatchedProblem:
    """Batched twin of ``PlacementProblem.score`` for candidate batches.

    ``evals`` counts logical candidate evaluations (what the seed's scalar
    loops counted); ``dispatches`` counts ``score_grid`` dispatches — the
    O(candidates) → O(dispatches) collapse the search layer exists for.
    """

    prob: PlacementProblem
    chunk: int = 4096
    device: str | torch.device | None = None
    # an already-built evaluator to reuse (same graph/cfg); None ⇒
    # BatchedEvaluator.shared(), one instance per (graph content, cfg,
    # device) across problems
    evaluator: BatchedEvaluator | None = None

    def __post_init__(self):
        self.evals = 0
        self.dispatches = 0
        # shape buckets this instance has dispatched (telemetry)
        self._seen_buckets: set[int] = set()
        self.scalar_fallback = self.prob.cost_cfg.include_compute
        if self.scalar_fallback:
            return
        if self.evaluator is not None:
            self._ev = self.evaluator
            if self.device is not None and \
                    dispatch.resolve_device(self.device) != self._ev.device:
                raise ValueError(
                    f"evaluator runs on {self._ev.device}, device= asks "
                    f"for {self.device}")
        else:
            self._ev = BatchedEvaluator.shared(
                self.prob.graph, self.prob.cost_cfg, device=self.device)
        dev = self._ev.device
        fleet = self.prob.fleet
        if isinstance(fleet, RegionFleet):
            self._pack = RegionFleetFamily.from_fleets([fleet])
            self._speed = None  # structured families carry their own speeds
        elif isinstance(fleet, ExplicitFleet):
            # float64 → float32 rounded once on the host, then ONE copy to
            # the device for the problem's lifetime
            com = np.asarray(fleet.com_matrix(), dtype=np.float32)
            self._pack = torch.from_numpy(com).to(dev)[None, :, :]
            self._speed = torch.as_tensor(
                np.asarray(fleet.effective_speed(), dtype=np.float32),
                device=dev)
        else:
            raise TypeError(f"unsupported fleet type {type(fleet).__name__}")
        obj = self.prob.objectives
        self._w_lat = 1.0
        if obj is not None:
            self._w_lat = dict(zip(obj.names, obj.weights)).get(
                "latency_f", 0.0)

    # -- raw batched values ---------------------------------------------------
    def _raw_chunk(self, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One padded chunk through score_grid at dq = 0: (latency (B,),
        dq-independent scalarization remainder (B,))."""
        b = xs.shape[0]
        bucket = _bucket(b)
        pad = bucket - b
        if pad:
            xs = np.concatenate([xs, np.repeat(xs[:1], pad, axis=0)])
        placements = xs.astype(np.float32)
        obj = self.prob.objectives
        self.dispatches += 1
        first = bucket not in self._seen_buckets
        reg = obs.registry()
        if reg.enabled:
            reg.counter("search.dispatches").add(1)
            reg.counter("search.candidates").add(b)
            reg.histogram("search.candidates_per_dispatch", lo=1.0).observe(b)
            if first:
                reg.counter("search.bucket_first_dispatch",
                            bucket=str(bucket)).add(1)
        self._seen_buckets.add(bucket)
        if obj is None:
            raw = self._ev.score_grid(placements, self._pack, dq=0.0,
                                      beta=0.0).cpu().numpy()
        else:
            speed = None if isinstance(self._pack, RegionFleetFamily) \
                else self._speed
            raw = self._ev.score_grid(placements, self._pack, dq=0.0,
                                      beta=0.0, objectives=obj,
                                      speed=speed).to_host()
        lat, rest, _ = split_dq_term(raw)       # (1, B) grids, S == 1
        return lat[0, :b], rest[0, :b]

    def raw_values(self, placements: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(latency (P,), dq-independent remainder (P,)) over chunked
        dispatches.  ``score = rest + w_lat · lat / (1 + β·dq)``."""
        xs = np.asarray(placements, dtype=np.float64)
        lats, rests = [], []
        for lo in range(0, xs.shape[0], self.chunk):
            lat, rest = self._raw_chunk(xs[lo:lo + self.chunk])
            lats.append(lat)
            rests.append(rest)
        # NaN is caught by score_grid's own guard when the sanitizer is
        # armed: every dispatch already syncs to bring its grid to the host
        return np.concatenate(lats), np.concatenate(rests)

    # -- feasibility ----------------------------------------------------------
    def feasible_mask(self, placements: np.ndarray,
                      dqs: np.ndarray) -> np.ndarray:
        """(P, D) DQCoupling feasibility — the vectorized twin of
        ``prob.feasible`` (:func:`repro_torch.search.decision.dq_caps_mask`)."""
        mask = dq_caps_mask(placements, dqs, self.prob.dq)
        if mask is None:
            return np.ones((placements.shape[0], dqs.shape[0]), dtype=bool)
        return mask

    def _validate(self, xs: np.ndarray) -> np.ndarray:
        """A typed AnalysisError for a mis-typed or mis-shaped batch before
        anything is packed; float64 placements out."""
        sanitize.check_placements(
            xs, self.prob.graph.n_ops, self.prob.fleet.n_devices,
            bucket=_bucket(min(xs.shape[0] if xs.ndim >= 3 else 1,
                               self.chunk)))
        return xs.astype(np.float64, copy=False)

    # -- the joint (placement × dq) score grid --------------------------------
    def score_batch(self, placements, dqs) -> np.ndarray:
        """(P, D) problem scores (∞ where infeasible) — ``prob.score`` for
        every (candidate, dq) pair of the cross product."""
        xs = self._validate(np.asarray(placements))
        if xs.ndim == 2:
            xs = xs[None]
        dq_arr = np.atleast_1d(np.asarray(dqs, dtype=np.float64))
        san = sanitize.state()
        if san.enabled and san.domain_check:
            sanitize.check_dq(dq_arr)
        P, D = xs.shape[0], dq_arr.shape[0]
        self.evals += P * D
        if self.scalar_fallback:
            return np.array([[self.prob.score(x, float(d)) for d in dq_arr]
                             for x in xs])
        with obs.span("search.score_batch", P=P, D=D):
            lat, rest = self.raw_values(xs)
        denom = 1.0 + self.prob.beta * dq_arr                      # (D,)
        scores = rest[:, None] + self._w_lat * lat[:, None] / denom[None, :]
        return np.where(self.feasible_mask(xs, dq_arr), scores, np.inf)

    def score_pairs(self, placements, dqs) -> np.ndarray:
        """(P,) problem scores for PAIRED (candidate_i, dq_i) inputs — one
        dq per candidate (e.g. an annealing path whose quality knob moves
        along the walk), so ``evals`` counts P, not a P×D cross product."""
        xs = self._validate(np.asarray(placements))
        dq_arr = np.broadcast_to(
            np.asarray(dqs, dtype=np.float64), (xs.shape[0],))
        san = sanitize.state()
        if san.enabled and san.domain_check:
            sanitize.check_dq(dq_arr)
        self.evals += xs.shape[0]
        if self.scalar_fallback:
            return np.array([self.prob.score(x, float(d))
                             for x, d in zip(xs, dq_arr)])
        lat, rest = self.raw_values(xs)
        scores = rest + self._w_lat * lat / (1.0 + self.prob.beta * dq_arr)
        if self.prob.dq is None:
            return scores
        col = xs.sum(axis=1)                                       # (P, V)
        caps = (np.asarray(self.prob.dq.cap0, dtype=np.float64)[None, :]
                - dq_arr[:, None] * np.asarray(self.prob.dq.load,
                                               dtype=np.float64)[None, :])
        feas = (col <= caps + 1e-7).all(axis=-1)                   # (P,)
        return np.where(feas, scores, np.inf)

    def best(self, placements, dqs) -> tuple[int, int, float]:
        """First-occurrence argmin over the (P, D) grid in candidate-major
        order — the seed loops' scan order — as (cand_idx, dq_idx, score)."""
        scores = self.score_batch(placements, dqs)
        k = int(np.argmin(scores))
        i, d = divmod(k, scores.shape[1])
        return i, d, float(scores[i, d])
