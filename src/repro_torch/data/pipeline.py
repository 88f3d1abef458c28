"""Streaming data pipeline: deterministic synthetic corpus, resumable
cursors, data-quality hooks, double-buffered prefetch — a copy of
``repro.data.pipeline`` (numpy; the port imports nothing of ``repro``).

The corpus is a stateless hash of (seed, position), so any batch is
reproducible from its cursor alone: checkpoint and restart are exact (the
cursor is part of the train state).

Data quality (the paper's ``DQ_fraction``): a configurable fraction of each
batch is scored by :func:`repro_torch.streaming.quality.quality_scores`;
low-quality rows are masked out of the loss (``loss_mask``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.streaming.quality import quality_scores

__all__ = ["PipelineConfig", "TokenStream", "Prefetcher"]


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dq_fraction: float = 0.0  # share of rows quality-checked per batch
    dq_missing_rate: float = 0.01  # synthetic corruption rate (sentinel -1)
    pad_id: int = 0


def _hash_tokens(seed: int, start: int, n: int, vocab: int) -> np.ndarray:
    """SplitMix64-style stateless generator — position-addressable stream."""
    idx = (np.arange(start, start + n, dtype=np.uint64)
           + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
    z = idx
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32)


class TokenStream:
    """Resumable batch iterator.  state = (cursor,) — one integer."""

    def __init__(self, cfg: PipelineConfig, cursor: int = 0):
        self.cfg = cfg
        self.cursor = int(cursor)

    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: PipelineConfig, state: dict) -> "TokenStream":
        if state.get("seed", cfg.seed) != cfg.seed:
            raise ValueError("checkpoint seed mismatch")
        return cls(cfg, cursor=state["cursor"])

    def next_batch(self) -> dict:
        cfg = self.cfg
        n = cfg.global_batch * (cfg.seq_len + 1)
        flat = _hash_tokens(cfg.seed, self.cursor, n, cfg.vocab)
        self.cursor += n
        arr = flat.reshape(cfg.global_batch, cfg.seq_len + 1)
        tokens = arr[:, :-1].copy()
        labels = arr[:, 1:].copy()
        batch = {"tokens": tokens, "labels": labels}
        if cfg.dq_fraction > 0.0:
            batch = self._apply_quality(batch)
        # the cursor AFTER this batch: consumers checkpoint the cursor of
        # the batch they trained on, not the prefetcher's read-ahead
        batch["_cursor"] = self.cursor
        return batch

    def _apply_quality(self, batch: dict) -> dict:
        """Corrupt a synthetic share of rows, then quality-score the
        configured DQ_fraction and mask low-quality rows from the loss."""
        cfg = self.cfg
        rng = np.random.default_rng(self.cursor)  # deterministic per batch
        tokens = batch["tokens"]
        B = tokens.shape[0]
        # synthetic corruption (sensor dropouts → sentinel id)
        corrupt = rng.random(B) < cfg.dq_missing_rate
        tokens = tokens.copy()
        tokens[corrupt, ::2] = -1  # half the row drops out
        checked = rng.random(B) < cfg.dq_fraction
        scores = quality_scores(tokens, missing_sentinel=-1)
        # unchecked rows are presumed fine (score forced to 1); clean rows
        # score ≈0.95+, half-missing rows ≈0.6 — threshold between them
        scores = np.where(checked, scores, 1.0)
        loss_mask = (scores >= 0.8).astype(np.float32)
        tokens = np.where(tokens < 0, cfg.pad_id, tokens)
        return {
            "tokens": tokens,
            "labels": batch["labels"],
            "loss_mask": np.broadcast_to(loss_mask[:, None],
                                         batch["labels"].shape).copy(),
        }


class Prefetcher:
    """Double-buffered host-side prefetch: a thread synthesises and
    quality-checks the next batches while the card computes."""

    def __init__(self, stream: TokenStream, depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.stream.next_batch()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
