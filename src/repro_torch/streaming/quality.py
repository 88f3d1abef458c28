"""Data-quality scoring (paper §3.1): completeness, validity, timeliness —
a copy of ``repro.streaming.quality`` (numpy; the port imports nothing of
``repro``).

``quality_scores`` rates rows in [0,1]; the paper's ``DQ_fraction`` decides
how many rows get scored (scoring costs compute/latency — eq. 8 prices that
trade-off), and β decides how much quality is worth.  The reference's
jitted twin ``quality_scores_jnp`` comes with ROADMAP A11.
"""

from __future__ import annotations

import numpy as np

__all__ = ["quality_scores", "dq_latency_model"]


def quality_scores(tokens: np.ndarray, missing_sentinel: int = -1,
                   weights=(0.5, 0.3, 0.2)) -> np.ndarray:
    """(B, S) int tokens → (B,) quality in [0,1].

    completeness: share of non-missing entries;
    validity: share of entries inside an expected z-score band;
    repetition: 1 − longest-run share (stuck-sensor detector).
    """
    B, S = tokens.shape
    missing = tokens == missing_sentinel
    completeness = 1.0 - missing.mean(axis=1)

    valid = tokens.astype(np.float64)
    valid[missing] = np.nan
    mu = np.nanmean(valid, axis=1, keepdims=True)
    sd = np.nanstd(valid, axis=1, keepdims=True) + 1e-9
    z = np.abs((valid - mu) / sd)
    validity = np.nan_to_num((z < 4.0), nan=0.0).mean(axis=1)

    same = tokens[:, 1:] == tokens[:, :-1]
    run = np.zeros(B)
    cur = np.zeros(B)
    for t in range(same.shape[1]):  # S is small for quality windows
        cur = np.where(same[:, t], cur + 1, 0)
        run = np.maximum(run, cur)
    repetition = 1.0 - run / max(S - 1, 1)

    w = np.asarray(weights)
    return (w[0] * completeness + w[1] * validity + w[2] * repetition) / w.sum()


def dq_latency_model(base_latency: float, dq_fraction: float,
                     beta: float) -> float:
    """Paper eq. (8) as used by the serving layer."""
    return base_latency / (1.0 + beta * dq_fraction)
