"""Fixture: must NOT trigger dtype-discipline in a float64 oracle."""
import numpy as np


def latency(x):
    return np.asarray(x, dtype=np.float64)
