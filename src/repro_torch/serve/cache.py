"""Per-bucket serving statistics — the PyTorch port's copy of
``repro.serve.cache``.

Each (CoalesceKey, padded-row bucket) pair tracks

  * dispatch count, rows scored, queries served, padding waste;
  * a latency :class:`repro_torch.obs.Histogram` (exponential buckets)
    whose p50/p95/p99 feed admission pricing — kept as a LOCAL instance so
    admission control works with the obs registry disabled, and mirrored
    into the registry when it is enabled;
  * recompiles and compile seconds, kept for schema parity with the
    reference: the port runs eagerly, so both stay 0.  The one-off build of
    the CUDA kernels is set-up time, counted once in
    :attr:`ServeStats.setup_s`, never inside a dispatch.

``BucketStats.snapshot()`` / ``ServeStats.snapshot()`` report per bucket.
"""

from __future__ import annotations

import dataclasses

from repro_torch import obs
from repro_torch.sim.execache import executable_cache

__all__ = ["BucketStats", "ServeStats"]

# dispatch latencies span ~100µs (tiny buckets) to seconds (V = 131 072
# grids); 1µs × 2^i covers that with ~½-decade resolution
_HIST_LO = 1e-6


@dataclasses.dataclass
class BucketStats:
    """Dispatch accounting for one (coalesce key, padded-rows) bucket."""

    bucket: int                       # padded super-batch rows
    dispatches: int = 0
    queries: int = 0                  # logical queries served via this bucket
    rows: int = 0                     # real (un-padded) candidate rows
    padded_rows: int = 0              # rows incl. padding actually scored
    recompiles: int = 0
    compile_s: float = 0.0
    warm: int = 0                     # dispatches that hit compiled code

    def __post_init__(self):
        self.latency = obs.Histogram("serve.dispatch_s",
                                     {"bucket": str(self.bucket)},
                                     lo=_HIST_LO)
        # compile-free dispatches only: the tail admission budgets bind
        # against (cold compiles are one-offs the executable cache kills)
        self.warm_latency = obs.Histogram("serve.dispatch_warm_s",
                                          {"bucket": str(self.bucket)},
                                          lo=_HIST_LO)

    def observe(self, seconds: float, n_rows: int, n_padded: int,
                n_queries: int, n_recompiles: int, compile_s: float) -> None:
        self.dispatches += 1
        self.queries += n_queries
        self.rows += n_rows
        self.padded_rows += n_padded
        self.recompiles += n_recompiles
        self.compile_s += compile_s
        if n_recompiles == 0:
            self.warm += 1
            self.warm_latency.observe(seconds)
        self.latency.observe(seconds)
        reg = obs.registry()
        if reg.enabled:
            b = str(self.bucket)
            reg.counter("serve.dispatches", bucket=b).add(1)
            reg.counter("serve.rows", bucket=b).add(n_rows)
            reg.counter("serve.recompiles", bucket=b).add(n_recompiles)
            reg.histogram("serve.dispatch_s", lo=_HIST_LO,
                          bucket=b).observe(seconds)

    def p99(self) -> float:
        return self.latency.quantile(0.99)

    def p99_warm(self) -> float:
        """p99 over compile-free dispatches only (NaN until one lands)."""
        return self.warm_latency.quantile(0.99)

    def snapshot(self) -> dict:
        """JSON-able per-bucket row (BENCH_serve / service.stats())."""
        pad = self.padded_rows - self.rows
        return {"bucket": self.bucket, "dispatches": self.dispatches,
                "queries": self.queries, "rows": self.rows,
                "padding_fraction": (pad / self.padded_rows
                                     if self.padded_rows else 0.0),
                "recompiles": self.recompiles, "compile_s": self.compile_s,
                "warm_dispatches": self.warm,
                "p99_warm": (self.p99_warm() if self.warm else None),
                **self.latency.quantiles()}


class ServeStats:
    """All buckets plus the executable cache totals, for one service."""

    def __init__(self):
        self._buckets: dict[int, BucketStats] = {}
        self.setup_s = 0.0      # one-off kernel build before the first dispatch
        self.admitted = 0
        self.degraded = 0
        self.rejected = 0

    def bucket(self, n: int) -> BucketStats:
        st = self._buckets.get(n)
        if st is None:
            st = self._buckets[n] = BucketStats(bucket=n)
        return st

    def peek_bucket(self, n: int) -> BucketStats | None:
        """The bucket's stats if it has ever dispatched, else None — the
        admission path must not materialize empty buckets."""
        return self._buckets.get(n)

    def buckets(self) -> list[BucketStats]:
        return [self._buckets[k] for k in sorted(self._buckets)]

    def snapshot(self) -> dict:
        """The serving-layer stats block: set-up seconds, admission counts,
        per-bucket dispatch/latency rows, and the process cache hit rates."""
        return {
            "setup_s": self.setup_s,
            "admission": {"admitted": self.admitted,
                          "degraded": self.degraded,
                          "rejected": self.rejected},
            "buckets": [b.snapshot() for b in self.buckets()],
            "executable_cache": executable_cache().stats(),
        }
