"""The learned cost prior: a small ridge model over the (operator, device)
featurization — the port of ``repro.belief.prior``.

Two independent heads, both linear in the features of
:mod:`repro_torch.belief.features`:

  * **device head** — predicts per-device log-slowdown (``log degrade``,
    0 = healthy) from device features;
  * **op head** — predicts per-operator log selectivity scale (0 = the
    nominal metadata is right) from op features.

Each head minimizes ONE weighted ridge loss (:func:`_ridge_loss`);
:func:`_ridge_solve` evaluates its exact minimizer from the normal
equations, in float32 as the reference's jitted program does.  The
reference has no Pallas kernel here: it forms the normal equations with an
XLA dot and solves them with LAPACK.  The port forms them with a pairwise
sum over the rows and solves them by Gaussian elimination with partial
pivoting, every step an elementwise torch op, so the fit is bitwise the
same on the card and on the CPU.  A library product or solve would sum in
an order of its own on each device, and these systems are ill-conditioned:
the speed-tier one-hots add up to the bias column, so only the ridge pins
that direction (condition 2·10⁴ on ``tests/test_belief.py``'s planted
tuples, millions for a fit over thousands of devices), and a last-bit
difference in the Gram matrix moves the float32 coefficients by far more
than 1e-5 (``ROADMAP.md``, Queue C).

The fit is *observation-count weighted*: a (device, window) tuple whose
estimate rests on 10⁴ work·rows of busy evidence moves the prior more than
a sliver-of-mass tuple — the same weights the belief posterior uses
(:class:`repro_torch.belief.state.BeliefState`).

:class:`LearnedPrior` keeps float64 host copies of the weights and predicts
in numpy, as the reference does, so the controller's per-tick decisions
never touch the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.torchmodel import require_fp32_matmul
from repro_torch.kernels import dispatch

__all__ = ["LearnedPrior", "fit_prior", "ridge_loss"]


def _design(x: torch.Tensor) -> torch.Tensor:
    """[1 | features] design matrix (bias absorbed as the first column)."""
    ones = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
    return torch.cat([ones, x], dim=1)


def _ridge_loss(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                sw: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Weighted ridge loss ``Σ_n sw_n (X_n·w − y_n)² + λ‖w₁:‖²`` (the bias
    is not penalized).  THE training objective — :func:`_ridge_solve`
    returns its exact minimizer."""
    require_fp32_matmul(x, "the ridge prior's loss")
    resid = _design(x) @ w - y
    penalty = lam * torch.sum(w[1:] ** 2)
    return torch.sum(sw * resid ** 2) + penalty


def _pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis by halving (zero-padded to a power of
    two): elementwise adds in one fixed order, so the card and the CPU
    round every partial sum alike."""
    n = t.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        t = torch.cat([t, t.new_zeros((size - n,) + tuple(t.shape[1:]))])
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        t = t[:half] + t[half:]
    return t[0]


def _eliminate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a·w = b`` by Gaussian elimination with partial pivoting (the
    first largest pivot), each update a separate elementwise product and
    difference, then back substitution column by column."""
    a, b = a.clone(), b.clone()
    n = a.shape[0]
    for k in range(n):
        p = k + int(torch.argmax(a[k:, k].abs()))
        if p != k:
            a[[k, p]] = a[[p, k]]
            b[[k, p]] = b[[p, k]]
        a[k + 1:, k] = a[k + 1:, k] / a[k, k]
        a[k + 1:, k + 1:] = a[k + 1:, k + 1:] \
            - a[k + 1:, k:k + 1] * a[k:k + 1, k + 1:]
        b[k + 1:] = b[k + 1:] - a[k + 1:, k] * b[k]
    w = torch.empty_like(b)
    for k in range(n - 1, -1, -1):
        w[k] = b[k] / a[k, k]
        b[:k] = b[:k] - a[:k, k] * w[k]
    return w


def _ridge_solve(x: torch.Tensor, y: torch.Tensor, sw: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """Exact minimizer of :func:`_ridge_loss` via the weighted normal
    equations (float32; the λ ridge keeps the system well-posed even with
    collinear one-hot tiers)."""
    d = _design(x)
    dw = d * sw[:, None]
    g = _pairwise_sum(dw[:, :, None] * d[:, None, :])
    reg = torch.eye(d.shape[1], dtype=torch.float32, device=x.device) * lam
    reg[0, 0] = 0.0
    rhs = _pairwise_sum(dw * y[:, None])
    return _eliminate(g + reg, rhs)


def _f32(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def ridge_loss(w: np.ndarray, feats: np.ndarray, targets: np.ndarray,
               weights: np.ndarray, ridge: float, device=None) -> float:
    """Host-facing view of the float32 training loss (diagnostics/tests),
    evaluated on ``device`` (``None`` → the card, ``"cpu"`` → the host)."""
    dev = dispatch.resolve_device(device)
    return float(_ridge_loss(_f32(w, dev), _f32(feats, dev),
                             _f32(targets, dev), _f32(weights, dev),
                             _f32(ridge, dev)))


def _fit_head(feats: np.ndarray, targets: np.ndarray, weights: np.ndarray,
              ridge: float, device: torch.device) -> np.ndarray:
    x = _f32(feats, device)
    y = _f32(targets, device)
    sw = _f32(weights, device)
    # scale-free weights: only relative evidence matters, and normalizing
    # keeps the float32 normal equations away from overflow for huge
    # work-mass units
    sw = sw / torch.clamp(_pairwise_sum(sw) / sw.shape[0], min=1e-30)
    w = _ridge_solve(x, y, sw, _f32(ridge, device))
    return w.cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class LearnedPrior:
    """Fitted prior weights (host-side float64 copies of the float32 fit).

    ``predict_*`` are pure numpy — prediction sits on the controller's
    decision path, where a device round trip per tick would violate the
    O(adaptations) dispatch budget."""

    w_device: np.ndarray | None      # (F_d + 1,) → log degrade
    w_op: np.ndarray | None          # (F_o + 1,) → log selectivity scale
    ridge: float
    n_device_samples: int
    n_op_samples: int
    # spread of the training residuals — the belief's prior variance
    device_residual_var: float = 0.25
    op_residual_var: float = 0.25

    def predict_log_degrade(self, feats: np.ndarray) -> np.ndarray:
        feats = np.asarray(feats, dtype=np.float64)
        if self.w_device is None:
            return np.zeros(feats.shape[0])
        pred = self.w_device[0] + feats @ self.w_device[1:]
        return np.clip(pred, np.log(1e-2), np.log(1e6))

    def predict_degrade(self, feats: np.ndarray) -> np.ndarray:
        """(V,) predicted slowdown multipliers (1 = healthy)."""
        return np.exp(self.predict_log_degrade(feats))

    def predict_log_sel_scale(self, feats: np.ndarray) -> np.ndarray:
        feats = np.asarray(feats, dtype=np.float64)
        if self.w_op is None:
            return np.zeros(feats.shape[0])
        pred = self.w_op[0] + feats @ self.w_op[1:]
        return np.clip(pred, np.log(1e-3), np.log(1e3))

    def predict_sel_scale(self, feats: np.ndarray) -> np.ndarray:
        """(n_ops,) predicted selectivity drift scales (1 = none)."""
        return np.exp(self.predict_log_sel_scale(feats))


def _head(feats, y, weights, ridge: float, device: torch.device):
    """(w, residual variance, rows) of one head, or the healthy default
    (None, 0.25, 0) when it has no rows."""
    if feats is None or not np.size(y):
        return None, 0.25, 0
    feats = np.asarray(feats, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    sw = np.ones(y.size) if weights is None \
        else np.asarray(weights, dtype=np.float64)
    w = _fit_head(feats, y, sw, ridge, device)
    resid = (w[0] + feats @ w[1:]) - y
    tot = sw.sum()
    var = float((sw * resid ** 2).sum() / tot) if tot > 0 else 0.25
    return w, var, int(y.size)


def fit_prior(device_features: np.ndarray | None = None,
              device_log_degrade: np.ndarray | None = None,
              device_weights: np.ndarray | None = None,
              op_features: np.ndarray | None = None,
              op_log_sel_scale: np.ndarray | None = None,
              op_weights: np.ndarray | None = None,
              ridge: float = 1e-2, device=None) -> LearnedPrior:
    """Fit the two ridge heads from harvested training tuples
    (:func:`repro_torch.sim.training.training_tuples` produces them from
    replay windows).  Either head may be absent (None / empty arrays) — the
    prior then predicts the healthy default for that head.

    The solves run on ``device``: ``None`` is the card (and raises without
    CUDA), ``"cpu"`` the host."""
    dev = dispatch.resolve_device(device)
    w_d, var_d, n_d = _head(device_features, device_log_degrade,
                            device_weights, ridge, dev)
    w_o, var_o, n_o = _head(op_features, op_log_sel_scale, op_weights,
                            ridge, dev)
    return LearnedPrior(w_device=w_d, w_op=w_o, ridge=float(ridge),
                        n_device_samples=n_d, n_op_samples=n_o,
                        device_residual_var=max(var_d, 1e-4),
                        op_residual_var=max(var_o, 1e-4))
