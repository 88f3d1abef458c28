"""Seeded weights, made on the device in one call per group of leaves.

A configuration's family (:mod:`portbench.families`) names its groups (the
embedding, one layer, the final norm with the head) and the shape and
initial scale of each leaf.  Each group draws one flat normal tensor from
a generator on the device seeded by (seed, group), and its leaves take
slices of it.  The same seed gives the same weights, and any group can be
made again alone: the reference makes each layer's when it needs it.  The
program's model must have exactly these leaves, named as its
``named_parameters()`` names them.
"""

from __future__ import annotations

import math

import torch

from portbench.families import family

_MASK = (1 << 64) - 1


def _mix(seed: int, group: int) -> int:
    z = (seed * 0x9E3779B97F4A7C15 + (group + 1) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 30)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def groups(model: dict) -> list[str]:
    """The groups of a configuration's leaves, in order."""
    return family(model).groups(model)


def leaves(model: dict, group: str) -> list[tuple[str, tuple, tuple]]:
    """(name, shape, init) of each leaf of ``group``."""
    return family(model).leaves(model, group)


def padded_vocab(model: dict) -> int:
    """The embedding and head tables' rows: the vocabulary rounded up to
    ``vocab_pad`` (the configuration's)."""
    m = model["vocab_pad"]
    return -(-model["vocab"] // m) * m


def make_group(model: dict, seed: int, group: str, device) -> dict:
    """``group``'s leaves (name → float32 tensor on ``device``)."""
    spec = leaves(model, group)
    n = sum(math.prod(shape) for _, shape, init in spec
            if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(_mix(seed,
                                                          groups(model)
                                                          .index(group)))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(init[1])
            at += size
        elif init[0] == "const":
            out[name] = torch.full(shape, init[1], device=device)
        elif init[0] == "log_linspace":
            out[name] = torch.log(torch.linspace(init[1], init[2], shape[0],
                                                 device=device))
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


@torch.no_grad()
def load_into(named: dict, model: dict, seed: int) -> None:
    """Fill the program's parameters ``named`` (name → tensor, as
    ``named_parameters()``) with the seed's weights, group by group.
    Raises ValueError unless the names and shapes are exactly this tree."""
    want = {n: s for g in groups(model) for n, s, _ in leaves(model, g)}
    have = {n: tuple(p.shape) for n, p in named.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's tree: {diff}")
    for g in groups(model):
        device = named[leaves(model, g)[0][0]].device
        for name, t in make_group(model, seed, g, device).items():
            named[name].copy_(t)
