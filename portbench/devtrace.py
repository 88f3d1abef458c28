"""Host spans, the device trace of a window, and its reduction.

Host spans are (name, start, end) on ``time.perf_counter``; the harness
records them around its calls into the program whether or not it traces.
With ``--trace 1`` a ``torch.profiler`` session records the card's
activity alone (kernels, copies, sets) over the window.  It opens with
``PAD`` spin kernels for it to drop (the profiler on that machine drops
the first device events of a session), then one spin kernel marks the
window's start and another, after the closing synchronize, its end; the
marks tie the device's clock to the host's, so every device interval is
given on the host clock.  The kernels are grouped by name as
``chip_smoke.py``'s ``device_profile`` groups them (``chip_smoke.py:3276``
and ``:4442``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from portbench.stats import idle_gaps

PAD = 256
# idle gaps shorter than this are summed apart, unlabelled
SHORT_GAP = 20e-6
SHORT = "gaps under 20 us"

# name → substrings of kernel names; the first group that matches takes a
# kernel, the rest is "other"
GROUPS = {
    "K7 backward": ("rmsnorm_bwd",),
    "K7": ("rmsnorm",),
    "K6 backward": ("ssd_bwd",),
    "K6": ("ssd_scan",),
    "K5": ("flash_attention",),
    "f32 GEMM": ("f32f32", "sgemm", "nvjet_sss", "nvjet_tss"),
    "bf16 GEMM": ("gemm", "cutlass", "xmma", "cublas", "nvjet"),
    "casts/copies": ("copy", "memcpy", "memset", "cast"),
    "conv/elementwise": ("elementwise", "vectorized", "unrolled", "cat",
                         "reduce"),
}


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS.items()
                 if any(k in low for k in keys)), "other")


class Spans:
    """Host spans in memory: ``with spans("name"):`` or :meth:`add`."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))

    def within(self, name: str, lo: float, hi: float):
        """Spans called ``name`` that start inside [lo, hi]."""
        return [(a, b) for n, a, b in self.items
                if n == name and lo <= a <= hi]


@dataclasses.dataclass
class DeviceTrace:
    """Device intervals (name, start, end) on the host clock, and the
    traced window [t0, t1] on the same clock."""

    ops: list[tuple[str, float, float]]
    t0: float
    t1: float

    def matching(self, key: str, exclude: str | None = None):
        return [(s, e) for n, s, e in self.ops
                if key in n and (exclude is None or exclude not in n)]


class Profiler:
    """The card's activity between :meth:`start` and :meth:`stop`."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self) -> float:
        """Open the session and return the window's start on the host
        clock."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.host0 = time.perf_counter()
        torch.cuda._sleep(1)
        return self.host0

    def stop(self) -> DeviceTrace:
        """Close the session after the window's work: synchronize, mark the
        end, and read the device's intervals."""
        torch = self.torch
        torch.cuda.synchronize()
        host1 = time.perf_counter()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        spins = sorted(s for n, s, _ in raw if "spin_kernel" in n)
        work = [(n, s, e) for n, s, e in raw if "spin_kernel" not in n]
        if len(spins) < 2:
            raise RuntimeError("the profiler recorded no window marks")
        first = min((s for _, s, _ in work), default=spins[-1])
        start_mark = max(s for s in spins if s <= first)
        end_mark = spins[-1]
        # device ns → host seconds: the start mark ran at host0
        ops = [(n, self.host0 + (s - start_mark) * 1e-9,
                self.host0 + (e - start_mark) * 1e-9) for n, s, e in work]
        # the host's seconds per device second between the marks: 1 but for
        # the launch latency of the end mark (a check on the tie)
        self.clock_ratio = (host1 - self.host0) / max(
            (end_mark - start_mark) * 1e-9, 1e-9)
        return DeviceTrace(ops, self.host0, host1)


def breakdown(trace: DeviceTrace, spans: Spans, lo: float,
              hi: float) -> dict:
    """The ten groups of device operations that took most time in [lo,
    hi], and the idle time of the device summed by the innermost host span
    open at each gap's start (the ten largest); gaps under ``SHORT_GAP``
    are summed under one name."""
    per: dict[str, float] = {}
    for n, s, e in trace.ops:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            g = group_of(n)
            per[g] = per.get(g, 0.0) + d
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    idle: dict[str, float] = {}
    names = [n for n, _, _ in spans.items]
    t0s = np.array([a for _, a, _ in spans.items])
    t1s = np.array([b for _, _, b in spans.items])
    for a, b in idle_gaps([(s, e) for _, s, e in trace.ops], lo, hi):
        label = SHORT
        if b - a >= SHORT_GAP:
            open_ = np.flatnonzero((t0s <= a) & (a < t1s))
            label = (names[open_[np.argmin(t1s[open_] - t0s[open_])]]
                     if open_.size else "outside any span")
        idle[label] = idle.get(label, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
