"""Fixture: triggers dtype-discipline in a float64 oracle module (never
imported, only linted)."""
import numpy as np
import torch


def latency(x):
    return np.asarray(x, dtype=np.float32)


def named(x):
    return np.asarray(x, dtype="float32")
