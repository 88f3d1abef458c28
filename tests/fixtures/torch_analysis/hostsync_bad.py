"""Fixture: triggers hidden-host-sync (never imported, only linted)."""
import numpy as np
import torch


def item_per_iteration(xs):
    total = 0.0
    for x in xs:
        total += torch.sum(x).item()  # a device→host copy per element
    return total


def float_per_iteration(x, n):
    out = []
    for _ in range(n):
        y = torch.exp(x)
        out.append(float(y.max()))  # sync per iteration
    return out


def pull_per_iteration(x):
    vals = torch.cumsum(x, 0)
    return [np.asarray(vals) for _ in range(3)]


def waits_per_iteration(fn, n):
    for _ in range(n):
        fn()
        torch.cuda.synchronize()


def unknown_receiver(xs):
    return [x.item() for x in xs]  # a tensor? then a sync each: warning
