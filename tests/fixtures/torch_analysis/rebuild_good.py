"""Fixture: must NOT trigger no-silent-rebuild."""
import ctypes
import functools

import torch

from repro_torch.kernels import build

_bound = None
DOUBLE = torch.compile(lambda v: v * 2.0)  # module level: built once


def _lib():
    global _bound
    if _bound is None:
        _bound = ctypes.CDLL("libkernels.so")
    return _bound


@functools.lru_cache(maxsize=None)
def compiled(fn):
    return torch.compile(fn)


def cached_loader():
    return build.load("edge_latency")  # build.load keeps its libraries


def hoisted(xs):
    lib = build.load("rmsnorm")
    return [lib.rmsnorm_launch(x) for x in xs]
