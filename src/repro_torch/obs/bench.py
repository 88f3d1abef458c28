"""Shared benchmark timing harness — the port's copy of
``repro.obs.bench``: warmup, flushing and median-of-n in one place.

  * :func:`measure`   — warmup calls, then n timed calls; every call is
    flushed with ``torch.cuda.synchronize`` on the card of each CUDA tensor
    it returned (the counterpart of ``jax.block_until_ready``), so queued
    kernels cannot leak past the clock.  Returns a :class:`Timing` with
    median/mean/min/max seconds on the host clock, as the reference, plus
    the kernel builds and loads of the TIMED region (``n_recompiles`` > 0
    after warmup = a kernel was built or opened inside the loop).
  * :func:`time_once` — one timed call returning ``(seconds, result)``.

The port has no jit: its counterpart of a compile is a CUDA kernel library
built with ``nvcc`` or opened by ``repro_torch.kernels.build.load``, which
:mod:`repro_torch.obs.kernelhooks` counts, as the reference takes its
compiles from ``jaxhooks``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from repro_torch.obs import kernelhooks

__all__ = ["Timing", "measure", "time_once"]


@dataclasses.dataclass
class Timing:
    """Timed-region summary; ``seconds`` (the headline number) is the
    median — robust to one-off scheduler noise, unlike mean or min."""

    times: list[float]
    n_recompiles: int
    compile_s: float
    # the LAST timed call's return value — benchmarks feed it to oracle
    # spot-checks without paying an extra call
    result: object = None

    @property
    def seconds(self) -> float:
        return statistics.median(self.times)

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.times)

    @property
    def min_s(self) -> float:
        return min(self.times)

    @property
    def max_s(self) -> float:
        return max(self.times)

    def row(self) -> dict:
        return {"seconds": self.seconds, "mean_s": self.mean_s,
                "min_s": self.min_s, "max_s": self.max_s,
                "n_timed": len(self.times),
                "n_recompiles": self.n_recompiles,
                "compile_s": self.compile_s}


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists,
    dicts and dataclasses)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


def _call_blocked(f, block: bool):
    out = f()
    if block:
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
    return out


def measure(f, n: int = 5, warmup: int = 1, block: bool = True) -> Timing:
    """``warmup`` un-timed calls (kernel builds land here), then ``n`` timed
    calls, each flushed as the module docstring says (``block=False`` for
    host callables).

    Build accounting covers the TIMED region only: ``n_recompiles`` counts
    the ``nvcc`` runs and library loads in it, ``compile_s`` their wall
    time (from :mod:`repro_torch.obs.kernelhooks`, armed here)."""
    if n < 1:
        raise ValueError(f"need n >= 1 timed calls, got {n}")
    for _ in range(warmup):
        _call_blocked(f, block)
    snap = kernelhooks.snapshot()
    times = []
    out = None
    for _ in range(n):
        t0 = time.perf_counter()
        out = _call_blocked(f, block)
        times.append(time.perf_counter() - t0)
    n_rec, comp_s = snap.delta()
    return Timing(times=times, n_recompiles=n_rec, compile_s=comp_s,
                  result=out)


def time_once(f, block: bool = True):
    """One timed call → ``(seconds, result)``, flushed like
    :func:`measure`.  No warmup: callers racing cold-vs-warm decide
    themselves what to warm."""
    t0 = time.perf_counter()
    out = _call_blocked(f, block)
    return time.perf_counter() - t0, out
