"""Process-local metrics registry: counters, gauges, histograms.

Zero-dependency, opt-in-cheap telemetry (a copy of ``repro.obs.registry``
for the PyTorch port).  The registry the instrumented subsystems publish
into (``BatchedEvaluator``, ``WhatIfService``, the kernel dispatch) is
DISABLED by default: every instrumentation site guards on
``registry().enabled`` (one attribute read), so an un-enabled process pays
nothing measurable on the hot loops.  Enabling never changes numerics:
instrumentation only *reads* values the computation already produced (no
rng draws, no extra dispatches).

Metric identity is ``(name, sorted labels)``; metrics are created lazily on
first use and cached, so call sites just say
``reg.counter("search.dispatches").add(1)``.

Histograms use exponential buckets (``lo · growth^i``): the observed
quantities span decades (µs dispatches to multi-second refits, 1-candidate
neighborhoods to 4096-candidate chunks), where linear buckets would waste
resolution.
"""

from __future__ import annotations

import dataclasses
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "set_registry", "enable", "disable", "enabled"]


def _key(name: str, labels: dict) -> tuple:
    return (name,) + tuple(sorted(labels.items()))


@dataclasses.dataclass
class Counter:
    """Monotone float accumulator (counts AND seconds-style totals)."""

    name: str
    labels: dict
    value: float = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n

    def row(self) -> dict:
        return {"type": "counter", "name": self.name, "labels": self.labels,
                "value": float(self.value)}


@dataclasses.dataclass
class Gauge:
    """Last-write-wins sample (drift level, belief com scale, ...)."""

    name: str
    labels: dict
    value: float = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)

    def row(self) -> dict:
        return {"type": "gauge", "name": self.name, "labels": self.labels,
                "value": float(self.value)}


class Histogram:
    """Exponential-bucket histogram: bucket i holds observations in
    ``(lo·growth^(i-1), lo·growth^i]``; underflows land in bucket 0,
    overflows in the last bucket.  Tracks sum/count/min/max exactly."""

    def __init__(self, name: str, labels: dict, lo: float = 1e-6,
                 growth: float = 2.0, n_buckets: int = 48):
        if lo <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError("need lo > 0, growth > 1, n_buckets >= 2")
        self.name = name
        self.labels = labels
        self.lo = float(lo)
        self.growth = float(growth)
        self.buckets = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._log_g = math.log(growth)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.lo:
            i = 0
        else:
            i = min(int(math.log(v / self.lo) / self._log_g) + 1,
                    len(self.buckets) - 1)
        self.buckets[i] += 1

    def bucket_upper_bounds(self) -> list[float]:
        return [self.lo * self.growth ** i for i in range(len(self.buckets))]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Estimated q-quantile from the exponential buckets.

        The crossing bucket is interpolated *geometrically* (the natural
        interpolation on a log-spaced grid: linear interpolation there
        over-weights the bucket's top end by up to the growth factor), and
        the estimate is clamped to the exactly-tracked [min, max] — so
        small-count histograms degrade to honest answers instead of
        bucket-edge artifacts, and q=0 / q=1 return min / max exactly.
        The worst-case estimation error within a bucket is a factor of
        ``growth`` (2× at the default), which is the resolution admission
        control needs: budgets are set in decades, not percent."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"need 0 <= q <= 1, got {q}")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.buckets):
            cum += c
            if cum >= target and c > 0:
                frac = (target - (cum - c)) / c          # position in bucket
                if i == 0:
                    est = self.lo * frac                  # (0, lo] linearly
                else:
                    # (lo·g^(i-1), lo·g^i] — geometric interpolation
                    est = self.lo * self.growth ** (i - 1 + frac)
                return float(min(max(est, self.min), self.max))
        return float(self.max)

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> dict[str, float]:
        """{"p50": ..., "p95": ..., "p99": ...} — the export admission
        control and the benchmark suites consume."""
        return {f"p{round(q * 100)}": self.quantile(q) for q in qs}

    def row(self) -> dict:
        return {"type": "histogram", "name": self.name, "labels": self.labels,
                "count": self.count, "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                "lo": self.lo, "growth": self.growth,
                "buckets": list(self.buckets),
                **({k: v for k, v in self.quantiles().items()}
                   if self.count else {"p50": None, "p95": None,
                                       "p99": None})}


class MetricsRegistry:
    """One process-local bag of metrics.  ``enabled`` is the single opt-in
    switch every instrumentation site checks before touching a metric."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kwargs):
        k = _key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            with self._lock:
                m = self._metrics.get(k)
                if m is None:
                    m = cls(name, labels, **kwargs)
                    self._metrics[k] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r}{labels} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, lo: float = 1e-6, growth: float = 2.0,
                  n_buckets: int = 48, **labels) -> Histogram:
        return self._get(Histogram, name, labels, lo=lo, growth=growth,
                         n_buckets=n_buckets)

    def get(self, name: str, **labels):
        """Metric lookup without creation (None when absent)."""
        return self._metrics.get(_key(name, labels))

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        m = self._metrics.get(_key(name, labels))
        return default if m is None else float(m.value)

    def snapshot(self) -> list[dict]:
        """JSON-able rows of every metric, sorted by (name, labels)."""
        return [self._metrics[k].row() for k in sorted(self._metrics)]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_registry = MetricsRegistry(enabled=False)


def registry() -> MetricsRegistry:
    """The process-local default registry (disabled until ``enable()``)."""
    return _registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the default registry (tests / multi-tenant isolation); returns
    the previous one."""
    global _registry
    prev, _registry = _registry, reg
    return prev


def enable() -> None:
    """Turn telemetry on: metrics record and spans buffer."""
    _registry.enabled = True


def disable() -> None:
    _registry.enabled = False


def enabled() -> bool:
    return _registry.enabled
