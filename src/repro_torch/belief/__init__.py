"""Learned cost priors with per-parameter uncertainty — the port of
``repro.belief``.

Instead of assuming the cost model's per-device / per-operator parameters
are known (the paper's setting) or learnable only for pairs the current
placement happens to touch (the replay refit), the package

  * featurizes devices and operators (:mod:`repro_torch.belief.features`)
    so a ridge prior (:mod:`repro_torch.belief.prior`) fit on
    replay-harvested tuples transfers to never-observed pairs, and
  * tracks an explicit posterior (:mod:`repro_torch.belief.state`) whose
    variance contracts with observation mass and re-inflates under age
    decay — feeding robust search posterior samples instead of fixed
    jitter, and telling the probing candidates which devices are worth
    paying to observe.

Features, state and predictions are numpy, bitwise equal to the
reference's; only :func:`fit_prior` (and :func:`ridge_loss`) run in torch,
on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.belief.features import (DEVICE_FEATURES, OP_FEATURES,
                                         device_features, op_features,
                                         speed_percentile)
from repro_torch.belief.prior import LearnedPrior, fit_prior, ridge_loss
from repro_torch.belief.state import BeliefState, apply_degrade

__all__ = [
    "DEVICE_FEATURES",
    "OP_FEATURES",
    "device_features",
    "op_features",
    "speed_percentile",
    "LearnedPrior",
    "fit_prior",
    "ridge_loss",
    "BeliefState",
    "apply_degrade",
]
