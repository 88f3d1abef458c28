"""Fixture: must NOT trigger checkpoint-purity."""
from torch.utils import checkpoint as ckpt

from repro_torch.models.transformer import remat_wrap

CALLS = []


def pure(x):
    parts = []
    parts.append(x * 2)  # a list the run makes itself
    return sum(parts)


def block(x, w):
    h = x @ w
    return h.relu()


def run(x, w):
    CALLS.append(1)  # outside the re-run region: once per step
    y = ckpt.checkpoint(pure, x, use_reentrant=False)
    return remat_wrap(block, "full")(y, w)
