"""Wrapper of the hand-written CUDA C++ SSD chunked-scan kernel (K6).

:func:`ssd_scan` replaces the Pallas kernel
``repro.kernels.ssd_scan.ssd_scan_pallas`` and computes what the Mamba2
forward's ``ssd_chunked`` returns as y; ``csrc/ssd_scan.cu``'s header says
what bounds it and how it is tiled.  It reads x (b, L, H, P) and B, C
(b, L, N) through their strides (the model passes views of one conv
output), takes any L (the ragged last chunk is masked in the kernel), any
H and the chunk Q from the caller, and writes a new contiguous y in x's
dtype.

The wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to
:func:`repro_torch.kernels.ref.ssd_scan_plain` — checks device, dtype,
shape, strides and the kernel's limits (P ≤ 64, N ≤ 128, shared memory),
launches on the current stream and raises if the launch was refused.
``launches["ssd_scan"]`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

__all__ = ["KERNELS", "MAX_P", "MAX_N", "SMEM_LIMIT", "launches",
           "reset_launches", "smem_bytes", "ssd_scan"]

KERNELS = ("ssd_scan",)
MAX_P, MAX_N = 64, 128
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
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
        lib = build.load("ssd_scan")
        lib.ssd_scan_launch.argtypes = [_P] * 7 + [_I] * 17 + [_P]
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def smem_bytes(N: int, P: int, Q: int) -> int:
    """Shared memory one CTA takes for (N, P, Q), in bytes: the layout of
    ``csrc/ssd_scan.cu`` (4 heads' states, C/B tiles of 32 rows with a
    pitch of N+1, the x tile, the C·Bᵀ tile and three (4, Q) scan rows)."""
    T, HB = 32, 4
    return 4 * (HB * N * P + T * (N + 1) + max(T * (N + 1), HB * T * (T + 1))
                + T * HB * P + T * (T + 1) + 3 * HB * Q)


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             chunk: int) -> torch.Tensor:
    """K6: x (b, L, H, P), B and C (b, L, N) float32 or bfloat16 (one
    dtype), dt (b, L, H), A and D (H,) float32 → y (b, L, H, P) in x's
    dtype, chunks of ``min(chunk, L)`` rows (see the module docstring)."""
    b, L, H, P, N, Q = ref.check_ssd_operands(x, B, C, dt, A, D, chunk)
    dev = x.device
    for name, t in (("x", x), ("B", B), ("C", C), ("dt", dt), ("A", A),
                    ("D", D)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version serves CPU tensors), got device "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x, B, C must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError(f"x needs a contiguous head dim and B, C a "
                         f"contiguous state dim; got strides {x.stride()}, "
                         f"{B.stride()}, {C.stride()}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"head dim {P} / state {N} above the kernel's "
                         f"{MAX_P} / {MAX_N}")
    if smem_bytes(N, P, Q) > SMEM_LIMIT:
        raise ValueError(f"chunk {Q} needs {smem_bytes(N, P, Q)} bytes of "
                         f"shared memory, above {SMEM_LIMIT}")
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(dev):     # launch on the operands' card
        rc = lib.ssd_scan_launch(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
            A.data_ptr(), D.data_ptr(), y.data_ptr(), b, L, H, P, N, Q,
            *x.stride()[:3], *B.stride()[:2], *C.stride()[:2],
            *dt.stride(), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()}")
    launches["ssd_scan"] += 1
    return y
