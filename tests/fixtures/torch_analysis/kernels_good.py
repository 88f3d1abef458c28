"""Fixture: must NOT trigger kernel-wrapper-constraints."""
import ctypes

import torch

_lib = ctypes.CDLL("libkernels.so")


def _check(name, t, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(name)
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(name)


def checked_in_a_loop(x, y):
    for name, t in (("x", x), ("y", y)):
        _check(name, t, tuple(x.shape))
    out = torch.empty_like(x)
    scratch = out if x.numel() else torch.zeros(1, device=x.device)
    _lib.k_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                  scratch.data_ptr())
    return out


def guarded_inline(g, x):
    _check("x", x, tuple(x.shape))
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError("g must match x")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    w = x.contiguous()
    out = torch.empty_like(x)
    _lib.k_launch(g.data_ptr(), w.data_ptr(), out.data_ptr())
    return out


def _launch(name, tensors):
    getattr(_lib, f"{name}_launch")(*(t.data_ptr() for t in tensors))


def through_the_helper(x, y):
    for name, t in (("x", x), ("y", y)):
        _check(name, t, tuple(x.shape))
    out = torch.empty_like(x)
    _launch("k", (x, y, out))
    return out
