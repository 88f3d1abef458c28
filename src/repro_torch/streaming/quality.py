"""Data-quality scoring (paper §3.1): completeness, validity, timeliness —
a copy of ``repro.streaming.quality`` (numpy; the port imports nothing of
``repro``).

``quality_scores`` rates rows in [0,1]; the paper's ``DQ_fraction`` decides
how many rows get scored (scoring costs compute/latency — eq. 8 prices that
trade-off), and β decides how much quality is worth.
:func:`quality_scores_torch` is the counterpart of the reference's jitted
twin ``quality_scores_jnp``: the same score in float32 on the card.
"""

from __future__ import annotations

import numpy as np

__all__ = ["quality_scores", "quality_scores_torch", "dq_latency_model"]


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


def quality_scores_torch(tokens, missing_sentinel: int = -1,
                         weights=(0.5, 0.3, 0.2), device=None):
    """(B, S) int tokens → (B,) float32 quality in [0,1] on ``device``.

    The counterpart of ``repro.streaming.quality.quality_scores_jnp``, term
    for term: completeness; validity from the float32 nanmean and the
    population nanstd (``jnp.nanstd``'s ddof 0; torch has no ``nanstd``, so
    it is the root of the nanmean of squared deviations); the ``z < 4``
    band under ``nan_to_num``; the longest run of repeats; the same
    weights.  A fully missing row scores what the reference gives it (0).
    The run lengths come from a cumulative max over the positions where a
    run breaks, so they are exact integers, as the reference's scan's are.
    ``device=None`` is the card (:func:`repro_torch.kernels.dispatch.
    resolve_device`); plain eager PyTorch, as the reference's twin is plain
    ``jnp`` with no kernel of its own.
    """
    import torch

    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    missing = tokens == missing_sentinel
    completeness = 1.0 - missing.float().mean(dim=1)

    valid = torch.where(missing, torch.nan, tokens.float())
    mu = torch.nanmean(valid, dim=1, keepdim=True)
    var = torch.nanmean((valid - mu) ** 2, dim=1, keepdim=True)
    sd = var.sqrt() + 1e-9
    z = ((valid - mu) / sd).abs()
    validity = torch.nan_to_num((z < 4.0).float()).mean(dim=1)

    # run[b] = the longest stretch of equal neighbours: at each position
    # the distance to the last break (a position whose neighbours differ)
    same = tokens[:, 1:] == tokens[:, :-1]
    pos = torch.arange(S - 1, device=dev).expand(B, S - 1)
    last_break = torch.where(same, -1, pos).cummax(dim=1).values \
        if S > 1 else pos
    cur = torch.where(same, pos - last_break, 0)
    run = cur.amax(dim=1).float() if S > 1 else torch.zeros(B, device=dev)
    repetition = 1.0 - run / max(S - 1, 1)

    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    return (w[0] * completeness + w[1] * validity
            + w[2] * repetition) / w.sum()


def dq_latency_model(base_latency: float, dq_fraction: float,
                     beta: float) -> float:
    """Paper eq. (8) as used by the serving layer."""
    return base_latency / (1.0 + beta * dq_fraction)
