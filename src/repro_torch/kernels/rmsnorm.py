"""Wrapper of the hand-written CUDA C++ RMSNorm kernel (K7).

:func:`rmsnorm` replaces the Pallas kernel
``repro.kernels.rmsnorm.rmsnorm_pallas``; ``csrc/rmsnorm.cu``'s header says
what bounds it and how it reads a row.  It normalises the last axis of a
contiguous x (float32 or bfloat16) with a float32 weight, computing in
float32, and writes a new tensor in x's dtype.

The wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to
:func:`repro_torch.kernels.ref.rmsnorm_plain` — checks device, dtype, shape
and contiguity, launches on the current stream and raises if the launch
was refused.  ``launches["rmsnorm"]`` counts launches, so a run can show
that its main path went through the kernel, and each launch reports
:func:`repro_torch.perf.roofline.rmsnorm_terms` for its rows to an open
``repro_torch.perf.counts`` counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.perf import counts, roofline

__all__ = ["KERNELS", "launches", "reset_launches", "rmsnorm"]

KERNELS = ("rmsnorm",)
launches = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_bound: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("rmsnorm")
        lib.rmsnorm_launch.argtypes = [_P] * 3 + [_I] * 3 + [ctypes.c_float,
                                                             _P]
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K7: x (..., D) float32 or bfloat16, contiguous; w (D,) float32 →
    ``x·rsqrt(mean(x²) + eps)·w`` in float32, in x's dtype."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version serves CPU tensors), got device "
                             f"{t.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if x.dim() < 1 or tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"w {tuple(w.shape)} does not match the last axis "
                         f"of x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    D = x.shape[-1]
    lib = _lib()
    dev = x.device
    with torch.cuda.device(dev):     # launch on the operands' card
        rc = lib.rmsnorm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // D, D,
            int(x.dtype == torch.bfloat16), float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("rmsnorm launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()}")
    launches["rmsnorm"] += 1
    if counts.ACTIVE:
        counts.report_kernel("rmsnorm", roofline.rmsnorm_terms(
            x.numel() // D, D, x.dtype))
    return out
