"""Frozen copies of the stream's semantics, for the reference to work out
again what the program derived from the benchmark's inputs.

* :func:`quality_scores` is ``src/repro_torch/streaming/quality.py:19-47``
  (completeness, validity in a z-band, repetition), and ``clean`` and the
  data-quality filter are ``examples/geo_placement.py``'s job: clip to
  [0, vocab − 1], keep rows scoring at least the threshold.
* :func:`split_rows` is ``src/repro_torch/streaming/engine.py:103-116``,
  the engine's proportional split of an operator's rows over its devices,
  which decides what each window_mean shard averages.
* :func:`stream_batch` is ``src/repro_torch/data/pipeline.py:38-104``
  (``_hash_tokens``, ``TokenStream.next_batch``, ``_apply_quality``): the
  tokens, labels and loss mask of a training batch, from the seed and the
  batch's place in the stream.
"""

from __future__ import annotations

import numpy as np


def quality_scores(tokens: np.ndarray, missing_sentinel: int = -1,
                   weights=(0.5, 0.3, 0.2)) -> np.ndarray:
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
    for t in range(same.shape[1]):
        cur = np.where(same[:, t], cur + 1, 0)
        run = np.maximum(run, cur)
    repetition = 1.0 - run / max(S - 1, 1)
    w = np.asarray(weights)
    return (w[0] * completeness + w[1] * validity + w[2] * repetition) \
        / w.sum()


def scored_rows(batch: np.ndarray, vocab: int,
                threshold: float) -> np.ndarray:
    """The rows of ``batch`` that reach the scoring operator, in order:
    cleaned, then kept where their quality reaches ``threshold``."""
    clean = np.clip(batch, 0, vocab - 1)
    keep = quality_scores(clean.astype(np.int64), missing_sentinel=-1) \
        >= threshold
    return clean[keep]


def split_rows(n: int, fractions: np.ndarray) -> list[tuple[int, int]]:
    """(start, stop) of each device's share of ``n`` rows, in device
    order, for devices that get any."""
    counts = np.floor(fractions * n).astype(int)
    rem = n - counts.sum()
    if rem > 0:
        order = np.argsort(-(fractions * n - counts))
        counts[order[:rem]] += 1
    out, start = [], 0
    for c in counts:
        if c > 0:
            out.append((start, start + int(c)))
            start += int(c)
    return out


def _hash_tokens(seed: int, start: int, n: int, vocab: int) -> np.ndarray:
    idx = (np.arange(start, start + n, dtype=np.uint64)
           + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
    z = idx
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32)


def stream_batch(seed: int, index: int, vocab: int, seq_len: int,
                 batch: int, dq_fraction: float,
                 missing_rate: float = 0.01, pad_id: int = 0) -> dict:
    """Batch ``index`` (from 0) of the synthetic stream: tokens, labels and
    the loss mask (ones where no row is masked), numpy."""
    n = batch * (seq_len + 1)
    cursor = index * n
    with np.errstate(over="ignore"):
        arr = _hash_tokens(seed, cursor, n, vocab).reshape(batch,
                                                           seq_len + 1)
    tokens, labels = arr[:, :-1].copy(), arr[:, 1:].copy()
    mask = np.ones(labels.shape, dtype=np.float32)
    if dq_fraction > 0.0:
        rng = np.random.default_rng(cursor + n)
        corrupt = rng.random(batch) < missing_rate
        tokens[corrupt, ::2] = -1
        checked = rng.random(batch) < dq_fraction
        scores = np.where(checked, quality_scores(tokens), 1.0)
        mask = np.broadcast_to((scores >= 0.8).astype(np.float32)[:, None],
                               labels.shape).copy()
        tokens = np.where(tokens < 0, pad_id, tokens)
    return {"tokens": tokens, "labels": labels, "loss_mask": mask}
