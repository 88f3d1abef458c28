"""Fixture: triggers dtype-discipline in a float32 batched twin (a module
under sim/; never imported, only linted)."""
import torch

from repro_torch.core.torchmodel import require_fp32_matmul


def widens(x):
    return x.to(torch.float64)  # the twin computes in float32


def doubles(x):
    return x.double()


def unguarded_product(x, com):
    return torch.matmul(x, com.T)  # TF32 would keep ~3 digits


def unguarded_operator(x, w):
    return x @ w


def guarded_too_late(x, com):
    y = torch.einsum("pv,uv->pu", x, com)
    require_fp32_matmul(x, "the product")  # after the product: no guard
    return y
