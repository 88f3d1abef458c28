"""Cost-priced admission control — a copy of ``repro.serve.admission`` for
the PyTorch port, pricing with the H100's data-sheet rates.

Every query is priced BEFORE dispatch from

  * an **analytic FLOPs/roofline prior** — the dominant terms of the edge
    kernels (dense ``2·B·E·V² + B·E·V``, structured ``2·B·E·R·V + B·E·V``)
    run through :func:`repro_torch.perf.roofline.compute_terms` — available
    for shape buckets the service has never executed;
  * a **calibration factor** — observed/prior ratio (running median of the
    last observations), because the prior is a hardware bound;
  * **observed per-bucket p99** — once a bucket has real dispatch history
    (:class:`repro_torch.serve.cache.BucketStats` histograms), its p99
    overrides the prior: measured tails beat models.

:func:`decide` compares ``backlog + predicted`` against the p99 budget and
returns a typed verdict: :class:`Admitted`, :class:`Degraded` (candidate
rows subsampled / dq grid coarsened, with the actions spelled out), or
:class:`Rejected` (with the price it refused to pay).
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

from repro_torch.perf.roofline import compute_terms

__all__ = ["AdmissionConfig", "Admitted", "Degraded", "Rejected",
           "DispatchPricer", "decide"]


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission knobs.

    ``p99_budget_s`` bounds the latency a query may add: predicted
    dispatch time plus the backlog already queued ahead of it.  Degrading
    (when allowed) subsamples the candidate batch to the largest row count
    whose price fits, and coarsens joint-query dq grids to
    ``degrade_dq_steps`` values; a query that cannot fit even at
    ``min_rows`` is rejected."""

    p99_budget_s: float = 0.25
    allow_degrade: bool = True
    min_rows: int = 8
    degrade_dq_steps: int = 5
    # prior→observed blend: ratio samples kept for the running median
    calibration_window: int = 32
    initial_calibration: float = 1.0
    # a bucket's own p99 takes over once it has this many observations
    min_bucket_obs: int = 3


@dataclasses.dataclass(frozen=True)
class Admitted:
    predicted_s: float


@dataclasses.dataclass(frozen=True)
class Degraded:
    """Admitted after degradation; ``actions`` names what was traded
    (``"subsample_candidates"``, ``"coarsen_dq_grid"``) and the kept
    shape, so tenants know the answer quality they bought."""

    predicted_s: float
    keep_rows: int
    of_rows: int
    dq_steps: int | None
    actions: tuple[str, ...]
    reason: str


@dataclasses.dataclass(frozen=True)
class Rejected:
    predicted_s: float
    budget_s: float
    backlog_s: float
    reason: str


class DispatchPricer:
    """Seconds-per-dispatch estimator for one evaluator family.

    ``graph_dims`` fixes (E, V[, R]); the per-row flop/byte counts are the
    dominant terms of the edge-latency grid dispatch.  Price =
    ``max(bucket p99, roofline_bound × calibration)`` — the prior keeps
    unseen buckets honest, the observed tail keeps seen buckets honest.
    """

    def __init__(self, n_edges: int, n_devices: int,
                 n_regions: int | None = None,
                 cfg: AdmissionConfig = AdmissionConfig()):
        self.E = int(n_edges)
        self.V = int(n_devices)
        self.R = None if n_regions is None else int(n_regions)
        self.cfg = cfg
        self._ratios: list[float] = []

    # -- the FLOPs/roofline prior --------------------------------------------
    def roofline_bound_s(self, n_scenarios: int, rows: int) -> float:
        """Roofline lower bound for one raw score_grid dispatch of
        ``rows`` placements × ``n_scenarios`` scenarios (perfect overlap,
        H100 data-sheet terms — a *bound*, scaled to the card actually in
        use by calibration)."""
        B = n_scenarios * rows
        if self.R is None:
            flops = 2.0 * B * self.E * self.V * self.V + B * self.E * self.V
            # operands re-read per edge: x_i/x_j (B·E·V) + com tiles (E·V²)
            bytes_ = 4.0 * (2.0 * B * self.E * self.V
                            + n_scenarios * self.E * self.V * self.V)
        else:
            flops = 2.0 * B * self.E * self.R * self.V \
                + B * self.E * self.V
            bytes_ = 4.0 * (2.0 * B * self.E * self.V
                            + n_scenarios * self.E * self.R * self.V)
        return compute_terms(flops, bytes_).step_time_s

    # -- calibration from observed dispatches --------------------------------
    def observe(self, n_scenarios: int, rows: int, seconds: float) -> None:
        """Fold one measured dispatch into the prior→host calibration
        (running median of observed/bound ratios over a sliding window;
        the median shrugs off one-off compile or scheduler outliers)."""
        bound = self.roofline_bound_s(n_scenarios, rows)
        if bound <= 0.0 or seconds <= 0.0:
            return
        self._ratios.append(seconds / bound)
        if len(self._ratios) > self.cfg.calibration_window:
            del self._ratios[0]

    @property
    def calibration(self) -> float:
        if not self._ratios:
            return self.cfg.initial_calibration
        return statistics.median(self._ratios)

    def price_s(self, n_scenarios: int, rows: int,
                bucket_stats=None) -> float:
        """Predicted seconds for a dispatch of this shape.  A bucket with
        enough real history prices by its own observed p99; otherwise the
        calibrated roofline prior."""
        prior = self.roofline_bound_s(n_scenarios, rows) * self.calibration
        if bucket_stats is not None \
                and bucket_stats.latency.count >= self.cfg.min_bucket_obs:
            return max(float(bucket_stats.p99()), prior * 0.0) or prior
        return prior


def decide(pricer: DispatchPricer, n_scenarios: int, rows: int,
           backlog_s: float, cfg: AdmissionConfig,
           dq_steps: int | None = None,
           bucket_stats=None) -> Admitted | Degraded | Rejected:
    """Price a query and admit / degrade / reject against the p99 budget.

    ``rows`` is the query's candidate count; ``dq_steps`` the length of a
    joint query's dq grid (None for non-joint kinds); ``backlog_s`` the
    predicted seconds of work already queued ahead of it."""
    budget = cfg.p99_budget_s
    predicted = pricer.price_s(n_scenarios, rows, bucket_stats)
    if backlog_s + predicted <= budget:
        return Admitted(predicted_s=predicted)
    if not cfg.allow_degrade:
        return Rejected(
            predicted_s=predicted, budget_s=budget, backlog_s=backlog_s,
            reason=f"predicted {predicted * 1e3:.2f}ms + backlog "
                   f"{backlog_s * 1e3:.2f}ms exceeds p99 budget "
                   f"{budget * 1e3:.2f}ms (degrade disabled)")
    actions: list[str] = []
    headroom = budget - backlog_s
    # the largest candidate PREFIX whose price fits the headroom (prefix,
    # not stride — sources order candidates best-first: incumbent first,
    # neighborhoods in scan order).  Binary search on the price function
    # itself: the roofline bound is affine in rows (a scenario-sized bytes
    # term doesn't scale with them), so inverting it linearly would
    # overshoot.  Degraded sizing prices through the calibrated prior
    # (bucket_stats=None) — shrinking the batch moves it to a different
    # bucket, so the original bucket's p99 no longer applies.
    lo, hi = min(cfg.min_rows, rows), rows
    if headroom <= 0.0 \
            or pricer.price_s(n_scenarios, lo) > headroom:
        return Rejected(
            predicted_s=predicted, budget_s=budget, backlog_s=backlog_s,
            reason=f"predicted {predicted * 1e3:.2f}ms + backlog "
                   f"{backlog_s * 1e3:.2f}ms exceeds p99 budget "
                   f"{budget * 1e3:.2f}ms even degraded to "
                   f"{lo}/{rows} candidates")
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pricer.price_s(n_scenarios, mid) <= headroom:
            lo = mid
        else:
            hi = mid - 1
    keep = lo
    new_dq = dq_steps
    if dq_steps is not None and dq_steps > cfg.degrade_dq_steps:
        new_dq = cfg.degrade_dq_steps
        actions.append("coarsen_dq_grid")
    if keep < rows:
        actions.append("subsample_candidates")
    degraded_price = pricer.price_s(n_scenarios, keep)
    if not actions:
        # the batch fits on the prior but the bucket's observed p99 says
        # otherwise, and there is nothing left to trade away
        return Rejected(
            predicted_s=predicted, budget_s=budget, backlog_s=backlog_s,
            reason=f"predicted {predicted * 1e3:.2f}ms + backlog "
                   f"{backlog_s * 1e3:.2f}ms exceeds p99 budget "
                   f"{budget * 1e3:.2f}ms with no degrade action left")
    return Degraded(
        predicted_s=degraded_price, keep_rows=keep, of_rows=rows,
        dq_steps=new_dq, actions=tuple(actions),
        reason=f"priced {predicted * 1e3:.2f}ms against "
               f"{max(headroom, 0.0) * 1e3:.2f}ms of budget headroom — "
               f"kept {keep}/{rows} candidates")
