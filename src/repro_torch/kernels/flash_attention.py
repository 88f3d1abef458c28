"""Wrapper of the hand-written CUDA C++ flash-attention kernel (K5).

:func:`flash_attention` replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention_pallas``;
``csrc/flash_attention.cu``'s header says what bounds it and how it is
tiled: bfloat16 operands run on the tensor cores (wgmma, TMA loads from a
producer warp), float32 operands on the CUDA cores, chosen by dtype before
the launch.  It reads the (B, S, H, D) operands through their strides (no
transposes; the bf16 route describes them to TMA as 4-D tensor maps),
takes any S (the ragged tile is masked inside the kernel) and writes a new
contiguous (B, S, H, D) output in q's dtype.

The wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to
:func:`repro_torch.kernels.ref.flash_attention_plain` — checks device,
dtype, shape, strides and alignment, launches on the current stream and
raises if the launch was refused.  ``launches["flash_attention"]`` counts
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

__all__ = ["KERNELS", "HEAD_DIMS", "MAX_Q_TILES", "launches",
           "reset_launches", "check_shape", "flash_attention"]

KERNELS = ("flash_attention",)
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_Q_TILES = 65535          # the grid's y dimension holds the q tiles
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
        lib = build.load("flash_attention")
        lib.flash_attention_launch.argtypes = \
            [_P] * 4 + [_I] * 19 + [ctypes.c_double, _P]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _check(name: str, t: torch.Tensor, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (the plain version "
                         f"serves CPU tensors), got device {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous head dim, (B, S, H) "
                         f"strides that are multiples of 8 elements and a "
                         f"16-byte aligned start; got strides {t.stride()}")


def check_shape(B: int, Sq: int, H: int, D: int) -> None:
    """Raise unless the kernel takes (B, Sq, H, D): a built head dim and
    at most :data:`MAX_Q_TILES` 64-row q tiles.  B·H is the grid's x
    dimension, which holds any batch the card can store."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if -(-Sq // 64) > MAX_Q_TILES:
        raise ValueError(f"Sq = {Sq} needs more than the grid's "
                         f"{MAX_Q_TILES} q tiles")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """K5: q, k, v (B, S, H, D), kv repeated to H, float32 or bfloat16 →
    (B, S, H, D) attention in q's dtype (see the module docstring).
    Causal attention needs Sq == Skv."""
    ref.check_attention_operands(q, k, v, causal)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    check_shape(B, Sq, H, D)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):     # launch on the operands' card
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(q.dtype == torch.bfloat16), int(causal),
            D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    launches["flash_attention"] += 1
    return out
