"""Fixture: must NOT trigger dtype-discipline (a module under sim/)."""
import torch

from repro_torch.core.torchmodel import require_fp32_matmul


def guarded(x, com):
    require_fp32_matmul(x, "the product")
    return torch.matmul(x, com.T)


def guarded_before_the_branch(x, w, weighted):
    require_fp32_matmul(x, "the product")
    if weighted:
        return x @ w
    return x.sum(-1)


def stays_float32(x):
    return x.to(torch.float32)
