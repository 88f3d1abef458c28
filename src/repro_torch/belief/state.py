"""The belief state: per-parameter posterior over the cost model's unknowns.

``refit_from_replay`` produces *point estimates* of per-device slowdown and
per-operator selectivity, and the legacy controller hedges against their
error with ad-hoc fixed-σ lognormal jitter — every device equally uncertain
forever.  :class:`BeliefState` replaces that with an explicit posterior in
log space:

  * **mean** — an observation-count-weighted blend of the running refit
    estimate and the learned prior (:class:`repro_torch.belief.prior.
    LearnedPrior`): ``(n·est + κ·prior) / (n + κ)``.  A device with ZERO
    observations returns *exactly* the prior mean (property-tested).
  * **variance** — ``prior_var · κ / (κ + n)``: monotone non-increasing in
    the observation count ``n``, so well-measured devices stop being
    jittered while never-observed ones keep their full prior spread.
  * **age decay** — :meth:`decay` shrinks the observation counts, which
    simultaneously RAISES the variance and relaxes the mean back toward the
    prior: stale evidence loses its grip exactly as fast for the mean as
    for the spread.

Observations arrive through :meth:`update_from_refit` (the calibration
layer calls it via ``refit_from_replay(..., belief=...)``), weighted by the
predicted work mass behind each per-device estimate — a stray sliver of
placement mass buys almost no posterior contraction.  :meth:`sample_fleets`
turns the posterior into robust-search scenario fleets: per-device
lognormal draws with the posterior σ, replacing the fixed-jitter
``perturbed_fleet`` copies.

numpy copy of ``repro.belief.state`` for the PyTorch port: the posterior,
its updates and its draws are bitwise equal to the reference's, the
generator's state after a draw included.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.belief.features import device_features, op_features
from repro_torch.belief.prior import LearnedPrior
from repro_torch.core.devices import ExplicitFleet

__all__ = ["BeliefState", "apply_degrade"]


def apply_degrade(fleet, degrade: np.ndarray) -> ExplicitFleet:
    """Materialize per-device slowdowns into an ExplicitFleet: links scale
    by ``d_u·d_v`` off-diagonal (the self-cost diagonal is kept) and speeds
    drop by ``d`` — the same structure ``refit_from_replay`` builds."""
    d = np.asarray(degrade, dtype=np.float64)
    com = np.asarray(fleet.com_matrix(), dtype=np.float64)
    com2 = com * np.outer(d, d)
    np.fill_diagonal(com2, np.diag(com))
    speed = np.asarray(fleet.effective_speed(), dtype=np.float64) / d
    return ExplicitFleet(com_cost=com2, speed=speed,
                         available=getattr(fleet, "available", None),
                         region=getattr(fleet, "region", None))


@dataclasses.dataclass
class BeliefState:
    """Posterior belief over per-device log-slowdown (and, optionally,
    per-op log selectivity scale), all relative to the BASE fleet the
    controller was handed.

    ``prior_strength`` is κ — how many (weight-normalized) observations the
    prior is worth.  ``cum_log`` tracks the slowdown the believed fleet
    currently carries (refits compose multiplicatively; the controller
    calls :meth:`commit` when it adopts one), so observations arriving as
    *relative* refit degrades can be anchored absolutely."""

    prior_mean_log: np.ndarray      # (V,) prior log-degrade
    prior_var: np.ndarray           # (V,) prior variance of log-degrade
    est_log: np.ndarray             # (V,) running observed log-degrade
    obs_count: np.ndarray           # (V,) effective observation counts
    cum_log: np.ndarray             # (V,) believed-fleet cumulative log-degrade
    prior_strength: float = 4.0
    # optional per-op selectivity-scale head (same machinery, log space)
    op_prior_mean_log: np.ndarray | None = None
    op_prior_var: np.ndarray | None = None
    op_est_log: np.ndarray | None = None
    op_obs_count: np.ndarray | None = None

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_fleet(cls, fleet, graph=None, prior: LearnedPrior | None = None,
                   prior_strength: float = 4.0,
                   default_var: float = 0.25) -> "BeliefState":
        """Belief over ``fleet``'s devices.  With a :class:`LearnedPrior`
        the prior mean is its featurized prediction (a never-observed
        device gets a calibrated estimate instead of "healthy"); without
        one the prior is the base fleet itself (log-degrade 0)."""
        v = fleet.n_devices
        if prior is not None:
            feats = device_features(fleet)
            mean = prior.predict_log_degrade(feats)
            var = np.full(v, max(prior.device_residual_var, 1e-4))
        else:
            mean = np.zeros(v)
            var = np.full(v, default_var)
        op_mean = op_var = op_est = op_cnt = None
        if graph is not None:
            n_ops = graph.n_ops
            if prior is not None and prior.w_op is not None:
                op_mean = prior.predict_log_sel_scale(op_features(graph))
                op_var = np.full(n_ops, max(prior.op_residual_var, 1e-4))
            else:
                op_mean = np.zeros(n_ops)
                op_var = np.full(n_ops, default_var)
            op_est = op_mean.copy()
            op_cnt = np.zeros(n_ops)
        return cls(prior_mean_log=mean, prior_var=var, est_log=mean.copy(),
                   obs_count=np.zeros(v), cum_log=np.zeros(v),
                   prior_strength=float(prior_strength),
                   op_prior_mean_log=op_mean, op_prior_var=op_var,
                   op_est_log=op_est, op_obs_count=op_cnt)

    @property
    def n_devices(self) -> int:
        return self.prior_mean_log.size

    # -- posterior ------------------------------------------------------------
    def posterior_mean_log(self) -> np.ndarray:
        """(V,) posterior mean log-degrade: the count-weighted blend.  At
        ``obs_count == 0`` this is EXACTLY ``prior_mean_log`` (guarded with
        a ``where``, not arithmetic that merely converges to it)."""
        k = self.prior_strength
        blend = (self.obs_count * self.est_log
                 + k * self.prior_mean_log) / (self.obs_count + k)
        return np.where(self.obs_count > 0.0, blend, self.prior_mean_log)

    def posterior_mean_degrade(self) -> np.ndarray:
        return np.exp(self.posterior_mean_log())

    def posterior_var(self) -> np.ndarray:
        """(V,) posterior variance of log-degrade:
        ``prior_var · κ / (κ + obs_count)`` — non-increasing in the count,
        exactly ``prior_var`` at zero observations."""
        k = self.prior_strength
        return self.prior_var * (k / (k + self.obs_count))

    def op_posterior_mean_log(self) -> np.ndarray | None:
        if self.op_est_log is None:
            return None
        k = self.prior_strength
        blend = (self.op_obs_count * self.op_est_log
                 + k * self.op_prior_mean_log) / (self.op_obs_count + k)
        return np.where(self.op_obs_count > 0.0, blend,
                        self.op_prior_mean_log)

    # -- updates --------------------------------------------------------------
    def observe(self, log_degrade: np.ndarray, weight: np.ndarray) -> None:
        """Count-weighted running update of the device estimates: entries
        with ``weight == 0`` are untouched."""
        w = np.asarray(weight, dtype=np.float64)
        est = np.asarray(log_degrade, dtype=np.float64)
        tot = self.obs_count + w
        upd = np.where(w > 0.0,
                       (self.obs_count * self.est_log + w * est)
                       / np.maximum(tot, 1e-30),
                       self.est_log)
        self.est_log = upd
        self.obs_count = tot

    def update_from_refit(self, refit) -> None:
        """Ingest one :class:`repro_torch.core.calibration.ReplayRefit`: the
        refit's per-device degrades (relative to the CURRENT believed
        fleet) become absolute observations via ``cum_log``, weighted by
        the predicted work mass behind each estimate (normalized so a
        typical well-observed device contributes ~1 count per window)."""
        if refit.obs_weight is None or refit.signal is None:
            return
        w = np.asarray(refit.obs_weight, dtype=np.float64).copy()
        sig = np.asarray(refit.signal, dtype=bool)
        w[~sig] = 0.0
        if sig.any():
            scale = float(np.median(w[sig]))
            if scale > 0.0:
                w = np.minimum(w / scale, 4.0)
        obs_log = self.cum_log + np.log(np.maximum(refit.degrade, 1e-12))
        self.observe(obs_log, w)
        if self.op_est_log is not None and refit.op_obs_weight is not None \
                and refit.sel_scale.size == self.op_est_log.size:
            ow = np.asarray(refit.op_obs_weight, dtype=np.float64).copy()
            pos = ow > 0.0
            if pos.any():
                s = float(np.median(ow[pos]))
                if s > 0.0:
                    ow = np.minimum(ow / s, 4.0)
            est = np.log(np.maximum(refit.sel_scale, 1e-12))
            tot = self.op_obs_count + ow
            self.op_est_log = np.where(
                ow > 0.0,
                (self.op_obs_count * self.op_est_log + ow * est)
                / np.maximum(tot, 1e-30),
                self.op_est_log)
            self.op_obs_count = tot

    def commit(self, degrade: np.ndarray) -> None:
        """Record that the believed fleet adopted a refit: future relative
        observations compose on top of this cumulative slowdown."""
        self.cum_log = self.cum_log \
            + np.log(np.maximum(np.asarray(degrade, dtype=np.float64),
                                1e-12))

    def decay(self, factor: float) -> None:
        """Age decay: one adaptation epoch passes, evidence fades.  Counts
        shrink by ``factor`` (< 1), so the posterior variance rises and the
        posterior mean relaxes toward the prior."""
        f = float(np.clip(factor, 0.0, 1.0))
        self.obs_count = self.obs_count * f
        if self.op_obs_count is not None:
            self.op_obs_count = self.op_obs_count * f

    def without_devices(self, keep: np.ndarray) -> "BeliefState":
        """Shrink the belief with the fleet on device removal."""
        keep = np.asarray(keep)
        return dataclasses.replace(
            self,
            prior_mean_log=self.prior_mean_log[keep],
            prior_var=self.prior_var[keep],
            est_log=self.est_log[keep],
            obs_count=self.obs_count[keep],
            cum_log=self.cum_log[keep])

    # -- consumers ------------------------------------------------------------
    def sample_degrade_rel(self, rng: np.random.Generator,
                           n: int) -> np.ndarray:
        """(n, V) multiplicative slowdown factors RELATIVE to the believed
        fleet: lognormal draws centered on the posterior mean's offset from
        the committed belief, spread by the posterior σ.  A well-observed
        device barely moves; a never-observed one swings with its full
        prior spread."""
        std = np.sqrt(self.posterior_var())
        center = self.posterior_mean_log() - self.cum_log
        noise = rng.standard_normal((n, self.n_devices))
        return np.exp(center[None, :] + std[None, :] * noise)

    def sample_fleets(self, base_fleet, rng: np.random.Generator,
                      n: int) -> list[ExplicitFleet]:
        """``n`` posterior-sampled what-if fleets around ``base_fleet`` —
        the drop-in replacement for fixed-jitter ``perturbed_fleet`` copies
        in min–max robust re-optimization."""
        rel = self.sample_degrade_rel(rng, n)
        return [apply_degrade(base_fleet, rel[k]) for k in range(n)]
