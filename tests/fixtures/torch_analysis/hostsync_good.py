"""Fixture: must NOT trigger hidden-host-sync."""
import torch


def transfer_once(xs):
    stacked = torch.stack(list(xs))
    return stacked.sum(-1).cpu().numpy()  # one copy after the work


def host_values(rows):
    return [float(r) for r in rows]  # host numbers, no tensor


def waits_once(fn, n):
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
