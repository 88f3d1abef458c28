"""Straggler detection: EWMA per-device step-time monitor — a copy of
``repro.runtime.stragglers`` (numpy only).

A device whose smoothed step time exceeds ``threshold ×`` the fleet median
is flagged; the caller (StreamingEngine / trainer) then degrades the
device's entry in the cost-model fleet and re-optimizes placement — the
paper's heterogeneous ``comCost`` / speed terms used as *live* state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    n_devices: int
    alpha: float = 0.3  # EWMA weight of the newest observation
    threshold: float = 1.8  # × median ⇒ straggler
    min_samples: int = 3

    def __post_init__(self):
        self.ewma = np.zeros(self.n_devices)
        self.samples = np.zeros(self.n_devices, dtype=int)

    def observe(self, step_times: np.ndarray):
        step_times = np.asarray(step_times, dtype=float)
        fresh = self.samples == 0
        self.ewma = np.where(fresh, step_times,
                             (1 - self.alpha) * self.ewma
                             + self.alpha * step_times)
        self.samples += 1

    def stragglers(self) -> list[tuple[int, float]]:
        """[(device, slowdown_factor)] for devices over threshold."""
        if (self.samples < self.min_samples).all():
            return []
        active = self.samples >= self.min_samples
        med = np.median(self.ewma[active]) if active.any() else 0.0
        if med <= 0:
            return []
        out = []
        for u in np.nonzero(active)[0]:
            ratio = self.ewma[u] / med
            if ratio > self.threshold:
                out.append((int(u), float(ratio)))
        return out

    def reset_device(self, u: int):
        self.ewma[u] = 0.0
        self.samples[u] = 0
