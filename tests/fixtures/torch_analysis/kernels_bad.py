"""Fixture: triggers kernel-wrapper-constraints (never imported, only
linted)."""
import ctypes

import torch

_lib = ctypes.CDLL("libkernels.so")


def _check(name, t, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(name)
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(name)


def unchecked_operand(x, y):
    _check("x", x, tuple(x.shape))
    out = torch.empty_like(x)
    _lib.k_launch(x.data_ptr(), y.data_ptr(), out.data_ptr())  # y: no check
    return out


def device_guard_only(x):
    if x.device.type != "cuda":
        raise ValueError("x must be a CUDA tensor")
    out = torch.empty_like(x)
    _lib.k_launch(x.data_ptr(), out.data_ptr())  # dtype, shape, layout?
    return out


def value_dependent_shapes(x, keep):
    _check("x", x, tuple(x.shape))
    rows = x[keep > 0]  # a shape the check never saw
    idx = torch.nonzero(keep)
    out = torch.empty((rows.shape[0], idx.shape[0]), device=x.device)
    _lib.k_launch(rows.data_ptr(), out.data_ptr())
    return out


def _launch(name, tensors):
    getattr(_lib, f"{name}_launch")(*(t.data_ptr() for t in tensors))


def through_the_helper(x, y):
    _check("x", x, tuple(x.shape))
    _launch("k", (x, y))  # y reaches the helper unchecked
