"""Runtime sanitizer — the part of ``repro.analysis.sanitize`` that the
PyTorch port's scoring path uses.

Catches what is only visible at runtime: NaN escaping a batched dispatch
and dq values outside the model's domain.  DISABLED by default; every
instrumented site guards on one attribute read (``sanitize.state().enabled``),
and the checks only READ values the computation already produced.

    from repro_torch.analysis import sanitize

    with sanitize.sanitized():
        ev.score_grid(xs, coms)       # raises AnalysisError on violation

:func:`check_dq` and :func:`check_finite` accept numpy arrays, scalars or
torch tensors (a CUDA tensor is copied to the host once for the check).
The reference's placement validation and retrace budget serve its search
engine and come with the search slice.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.analysis.errors import AnalysisError

__all__ = ["AnalysisError", "SanitizerState", "state", "enabled", "enable",
           "disable", "sanitized", "check_dq", "check_finite"]


@dataclasses.dataclass
class SanitizerState:
    """Process-local switchboard; ``enabled`` is the one-attribute-read
    hot-path guard (mirroring ``repro_torch.obs.registry().enabled``)."""

    enabled: bool = False
    nan_check: bool = True
    domain_check: bool = True


_state = SanitizerState()


def state() -> SanitizerState:
    return _state


def enabled() -> bool:
    return _state.enabled


def enable(nan_check: bool = True, domain_check: bool = True) -> None:
    """Arm the sanitizer."""
    _state.enabled = True
    _state.nan_check = nan_check
    _state.domain_check = domain_check


def disable() -> None:
    _state.enabled = False


@contextlib.contextmanager
def sanitized(nan_check: bool = True, domain_check: bool = True):
    """Enable for the duration of a block; restores the prior state."""
    prior = dataclasses.replace(_state)
    enable(nan_check=nan_check, domain_check=domain_check)
    try:
        yield _state
    finally:
        _state.enabled = prior.enabled
        _state.nan_check = prior.nan_check
        _state.domain_check = prior.domain_check


def _host(arr) -> np.ndarray:
    """numpy view of a tensor (any device) or array-like."""
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


# -- domain checks (plain functions: usable without enabling) -----------------

def check_dq(dq, *, bucket=None) -> None:
    """dq_fraction lives in [0, 1]: the fraction of rows degraded away."""
    if type(dq) is float or type(dq) is int:  # hot-path scalar fast path
        if 0.0 <= dq <= 1.0:
            return
    arr = _host(dq).astype(np.float64)
    # NaN propagates through min/max and fails both comparisons, so two
    # scalar reductions cover range AND the non-finite case
    if arr.size and not (arr.min() >= 0.0 and arr.max() <= 1.0):
        raise AnalysisError(
            "dq-domain",
            f"dq_fraction outside [0, 1] (or non-finite): "
            f"min={float(arr.min())}, max={float(arr.max())}",
            bucket=bucket)


def check_finite(name: str, arr, *, allow_inf: bool = True,
                 bucket=None) -> None:
    """NaN (and optionally Inf) guard on a dispatch output.  ``allow_inf``
    defaults True because +inf is the legitimate infeasible marker."""
    a = _host(arr)
    # single-pass screen: any NaN poisons the sum, and Inf survives it,
    # so a finite sum proves the whole array clean
    s = float(a.sum(dtype=np.float64)) if a.size else 0.0
    if s - s == 0.0 and allow_inf:
        return
    if np.isnan(a).any():
        raise AnalysisError(
            "nan-guard",
            f"{name} produced {int(np.isnan(a).sum())} NaN(s)",
            name=name, bucket=bucket)
    if not allow_inf and np.isinf(a).any():
        raise AnalysisError(
            "nan-guard",
            f"{name} produced {int(np.isinf(a).sum())} Inf(s)",
            name=name, bucket=bucket)
