"""Wrapper of the hand-written CUDA C++ RMSNorm kernel (K7) and of its
backward.

:func:`rmsnorm` replaces the Pallas kernel
``repro.kernels.rmsnorm.rmsnorm_pallas``; ``csrc/rmsnorm.cu``'s header says
what bounds it and how it reads a row.  It normalises the last axis of a
contiguous x (float32 or bfloat16) with a float32 weight, computing in
float32, and writes a new tensor in x's dtype.

:func:`rmsnorm_bwd` is K7's gradient, a kernel of its own in the same
source (the Pallas kernel has none: the reference trains through the
plain ``rms_norm``).  From x, w and the upstream gradient g it writes dx in
x's dtype and dw in float32, deterministically (per-CTA dw partials summed
in a fixed order, no atomics, in the same launch where the card holds the
whole grid at once).  :class:`RMSNormFunction` ties the two
together for autograd: its forward launches :func:`rmsnorm` and saves x
and w, its backward launches :func:`rmsnorm_bwd`.  Both are looked up in
this module when called, so a caller may swap either for another version
(``chip_smoke.py`` swaps in the plain ones and a planted fault).

The wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to
:func:`repro_torch.kernels.ref.rmsnorm_plain` — checks device, dtype, shape
and contiguity, launches on the current stream and raises if the launch
was refused.  ``launches["rmsnorm"]`` and ``launches["rmsnorm_bwd"]`` count
launches, so a run can show that its main path went through the kernels,
and each launch reports :func:`repro_torch.perf.roofline.rmsnorm_terms`
(:func:`~repro_torch.perf.roofline.rmsnorm_bwd_terms`) for its rows to an
open ``repro_torch.perf.counts`` counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.perf import counts, roofline

__all__ = ["KERNELS", "launches", "reset_launches", "rmsnorm", "rmsnorm_bwd",
           "bwd_partials", "last_bwd_route", "RMSNormFunction",
           "rmsnorm_autograd"]

KERNELS = ("rmsnorm", "rmsnorm_bwd")
launches = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_bound: ctypes.CDLL | None = None
_bound_bwd: ctypes.CDLL | None = None


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


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
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


def _bwd_lib() -> ctypes.CDLL:
    """The library with the backward's entry points bound too (on its
    first use)."""
    global _bound_bwd
    if _bound_bwd is None:
        lib = _lib()
        lib.rmsnorm_bwd_launch.argtypes = [_P] * 6 + [_I] * 3 + [
            ctypes.c_float, _I, _P]
        lib.rmsnorm_bwd_launch.restype = ctypes.c_int
        lib.rmsnorm_bwd_partials.argtypes = [_I, _I]
        lib.rmsnorm_bwd_partials.restype = _I
        lib.rmsnorm_bwd_last_route.argtypes = []
        lib.rmsnorm_bwd_last_route.restype = ctypes.c_int
        _bound_bwd = lib
    return _bound_bwd


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K7: x (..., D) float32 or bfloat16, contiguous; w (D,) float32 →
    ``x·rsqrt(mean(x²) + eps)·w`` in float32, in x's dtype.  The output
    has no ``grad_fn``: a caller that needs the gradient goes through
    :func:`rmsnorm_autograd`."""
    _check(x, w)
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


# the backward's widest row (csrc/rmsnorm.cu BWD_MAX_D): every norm of the
# registry is inside it (d_model <= 7168, Mamba2's d_inner 4096)
BWD_MAX_D = 8192
# csrc/rmsnorm.cu's bwd_grid: a CTA for every BWD_MIN_ROWS rows, at most
# BWD_CTAS for rows of BWD_WIDE_D elements or more, up to BWD_SPREAD times
# as many for narrower rows
BWD_MIN_ROWS, BWD_CTAS, BWD_WIDE_D, BWD_SPREAD = 8, 264, 2048, 8
# what rmsnorm_bwd_last_route says of a launch
BWD_ROUTES = ("scalar rows + dw sum", "ring + dw sum", "ring, dw sum fused")


def bwd_partials(rows: int, D: int) -> int:
    """The CTAs of the backward's grid for a (rows, D) x, and so the rows
    of its float32 (·, D) dw scratch: ``csrc/rmsnorm.cu``'s ``bwd_grid``
    (``rmsnorm_bwd_partials``), a function of rows and D alone."""
    if rows < 1 or D < 1:
        return 0
    spread = min(max(BWD_WIDE_D // D, 1), BWD_SPREAD)
    return min(-(-rows // BWD_MIN_ROWS), BWD_CTAS * spread)


def last_bwd_route() -> str:
    """How this thread's last backward launch ran (``BWD_ROUTES``): the
    rows through the ring or one element a load, and whether the dw sum
    was fused into the same (cooperative) launch."""
    return BWD_ROUTES[_bwd_lib().rmsnorm_bwd_last_route()]


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6, *, fuse: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's backward: x (..., D) float32 or bfloat16 and the upstream
    gradient g of its shape and dtype, contiguous; w (D,) float32, D ≤
    8192 → (dx in x's dtype, dw (D,) float32) with r = rsqrt(mean(x²) +
    eps): ``dx = r·g·w − x·r³·mean(x·g·w)``, ``dw = Σ_rows g·x·r``.
    Deterministic: a repeat launch is bitwise identical.  ``fuse=False``
    sums dw in a launch of its own even where the card holds the whole
    grid at once (the same order, so the same bits)."""
    _check(x, w)
    dev = x.device
    if g.device != dev or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"g ({tuple(g.shape)}, {g.dtype}, {g.device}) "
                         f"must match x ({tuple(x.shape)}, {x.dtype}, "
                         f"{dev})")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    D = x.shape[-1]
    if D > BWD_MAX_D:
        raise ValueError(f"the backward takes rows of at most {BWD_MAX_D} "
                         f"elements, got {D}")
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=dev)
    if dx.numel() == 0:         # no rows: dw is an empty sum
        return dx, dw.zero_()
    rows = x.numel() // D
    partial = torch.empty((bwd_partials(rows, D), D), dtype=torch.float32,
                          device=dev)
    lib = _bwd_lib()
    args = (x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), rows, D,
            int(x.dtype == torch.bfloat16), float(eps), int(fuse))
    if dev.index == torch.cuda.current_device():
        rc = lib.rmsnorm_bwd_launch(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:                       # launch on the operands' card
        with torch.cuda.device(dev):
            rc = lib.rmsnorm_bwd_launch(
                *args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError("rmsnorm backward launch failed: "
                           f"{lib.rmsnorm_error_string(rc).decode()}")
    launches["rmsnorm_bwd"] += 1
    if counts.ACTIVE:
        counts.report_kernel("rmsnorm_bwd",
                             roofline.rmsnorm_bwd_terms(rows, D, x.dtype))
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """K7 with its gradient: forward :func:`rmsnorm` (x and w saved, the
    forward keeps nothing else), backward :func:`rmsnorm_bwd` on the
    upstream gradient made contiguous."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw, None


def rmsnorm_autograd(x: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` with a ``grad_fn`` whose backward is K7's backward
    kernel (:class:`RMSNormFunction`)."""
    return RMSNormFunction.apply(x, w, eps)
