"""Fixture: triggers checkpoint-purity (never imported, only linted)."""
from torch.utils import checkpoint as ckpt

from repro_torch.models.transformer import remat_wrap

CALLS = []
COUNTS = {"forward": 0}


def noisy(x):
    print("forward", x)  # prints again when the backward re-runs it
    return x * 2


def publishes(x):
    CALLS.append(1)  # appended twice per step
    COUNTS["forward"] += 1  # counted twice per step
    return x + 1


class Block:
    def forward(self, x):
        self.seen = x.shape  # written again in the backward
        return x


def run(x, blk):
    y = ckpt.checkpoint(noisy, x, use_reentrant=False)
    z = remat_wrap(publishes, "full")(y)
    return remat_wrap(blk.forward, "full")(z)
