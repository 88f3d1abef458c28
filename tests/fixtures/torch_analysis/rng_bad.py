"""Fixture: triggers rng-discipline (never imported, only linted)."""
import numpy as np
import torch


def global_state_draw(n):
    return np.random.rand(n)  # mutates GLOBAL numpy rng state


def seeds_global_state():
    np.random.seed(0)


def seeds_torch_globally():
    torch.manual_seed(0)


def draws_without_generator(n):
    return torch.randn(n)


def fills_without_generator(t):
    return t.normal_()
