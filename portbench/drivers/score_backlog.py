"""``score_backlog``: the example's streaming job with batches of a fixed
size sent one after the other, the next as soon as the last returns.
Reports ``score_tokens_per_s``: the tokens of every record the scoring
operator took in the window's batches, over the time from the window's
start to the last batch's return."""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers import make_records, seeded, synchronize
from portbench.drivers._scoring import FAULTS, Scoring
from portbench.stats import window_rate

__all__ = ["Driver", "FAULTS"]


class Driver(Scoring):
    """Batches of ``records_per_batch`` records sent back to back."""

    def _batch(self, i: int) -> np.ndarray:
        tr = self.tr
        return make_records(seeded(self.seed, 2, i), tr["records_per_batch"],
                            tr["tokens_per_record"], self.run.model["vocab"],
                            tr["dropout_share"])

    def setup(self) -> None:
        super().setup()
        self.run_batch(self._batch(1 << 20), keep=False)     # the warm-up
        synchronize(self.torch, self.device)

    def window(self, seconds: float, t0: float) -> float:
        units = []
        model_ix = self.kinds.index("model")
        while time.perf_counter() < t0 + seconds:
            report = self.run_batch(self._batch(len(units)))
            units.append((report.op_rows_in[model_ix]
                          * self.tr["tokens_per_record"],
                          time.perf_counter()))
        self.units = units
        self.count_window()
        return units[-1][1]

    def end_to_end(self, t0: float) -> dict:
        return {"score_tokens_per_s": window_rate(self.units, t0)}

    def attempted(self) -> int:
        return len(self.units) * self.tr["records_per_batch"]
