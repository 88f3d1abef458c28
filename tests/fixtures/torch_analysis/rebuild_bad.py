"""Fixture: triggers no-silent-rebuild (never imported, only linted)."""
import ctypes

import torch

from repro_torch.kernels import build


def lambda_captures_loop_var(xs):
    out = []
    for scale in xs:
        f = torch.compile(lambda v: v * scale)  # a fresh program per `scale`
        out.append(f(scale))
    return out


def reloads_in_loop(n):
    libs = []
    for _ in range(n):
        libs.append(build.load("edge_latency"))  # loop-invariant: hoist it
    return libs


def per_iteration_program(fns, xs):
    out = []
    for fn, x in zip(fns, xs):
        out.append(torch.jit.script(fn)(x))  # varies per iteration: warning
    return out


def opens_library_per_call(path):
    lib = ctypes.CDLL(path)  # a fresh handle on every call
    return lib.launch()
