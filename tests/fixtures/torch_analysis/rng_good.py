"""Fixture: must NOT trigger rng-discipline."""
import numpy as np
import torch


def seeded_draw(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n)


def seeded_torch_draw(n, seed, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=gen, device=device)


def seeded_fill(t, gen):
    return t.normal_(generator=gen)
