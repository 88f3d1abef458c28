"""Placements: the paper's decision variable ``x_{i,u}``.

A placement is an (n_ops, n_devices) row-stochastic matrix — each operator's
tuples are fractionally partitioned across devices (paper's massive
parallelism).  Availability masks (``available_{i,u}``) force zeros; capacity
bounds cap per-device mass (used by the DQ coupling).  numpy-only copy of
``repro.core.placement`` for the PyTorch port.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "validate_placement",
    "random_placement",
    "uniform_placement",
    "project_rows_to_simplex",
    "project_with_caps",
]


def validate_placement(x: np.ndarray, available: np.ndarray | None = None,
                       atol: float = 1e-6) -> None:
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"placement must be 2-D (ops, devices), got {x.shape}")
    if (x < -atol).any():
        raise ValueError("placement has negative fractions")
    rows = x.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=atol):
        bad = np.argmax(np.abs(rows - 1.0))
        raise ValueError(f"row {bad} sums to {rows[bad]}, want 1.0")
    if available is not None and (x[~np.asarray(available, dtype=bool)] > atol).any():
        raise ValueError("placement assigns mass to unavailable (op, device) pairs")


def uniform_placement(n_ops: int, available: np.ndarray) -> np.ndarray:
    """Spread each operator evenly over its available devices."""
    a = np.asarray(available, dtype=np.float64)
    if (a.sum(axis=1) == 0).any():
        raise ValueError("some operator has no available device")
    return a / a.sum(axis=1, keepdims=True)


def random_placement(n_ops: int, available: np.ndarray,
                     rng: np.random.Generator, sparsity: float = 0.0) -> np.ndarray:
    """Dirichlet-random rows restricted to available devices.

    sparsity>0 randomly zeroes that fraction of available slots first (keeps
    at least one), producing the sparse placements real deployments use.
    """
    a = np.asarray(available, dtype=bool).copy()
    n_dev = a.shape[1]
    x = np.zeros((n_ops, n_dev))
    for i in range(n_ops):
        idx = np.flatnonzero(a[i])
        if sparsity > 0.0 and idx.size > 1:
            keep = rng.random(idx.size) >= sparsity
            if not keep.any():
                keep[rng.integers(idx.size)] = True
            idx = idx[keep]
        w = rng.gamma(1.0, 1.0, size=idx.size)
        x[i, idx] = w / w.sum()
    return x


def project_rows_to_simplex(x: np.ndarray, available: np.ndarray | None = None) -> np.ndarray:
    """Euclidean projection of each row onto the probability simplex
    (Duchi et al. 2008), respecting the availability mask."""
    x = np.asarray(x, dtype=np.float64).copy()
    n_ops, n_dev = x.shape
    if available is not None:
        x[~np.asarray(available, dtype=bool)] = -np.inf
    out = np.zeros_like(x)
    for i in range(n_ops):
        row = x[i]
        finite = np.isfinite(row)
        v = row[finite]
        u = np.sort(v)[::-1]
        css = np.cumsum(u)
        rho = np.nonzero(u * np.arange(1, v.size + 1) > (css - 1.0))[0][-1]
        theta = (css[rho] - 1.0) / float(rho + 1)
        out[i, finite] = np.maximum(v - theta, 0.0)
    return out


def project_with_caps(x: np.ndarray, caps: np.ndarray,
                      available: np.ndarray | None = None,
                      iters: int = 50) -> np.ndarray:
    """Approximate projection onto {rows on simplex, column mass ≤ caps}.

    Alternating projection (simplex rows ↔ clip column mass); converges to a
    feasible point when one exists (Σcaps ≥ n_ops).  Used by the DQ-coupled
    optimizer where quality checks eat device capacity (DESIGN.md §2).
    """
    caps = np.asarray(caps, dtype=np.float64)
    y = project_rows_to_simplex(x, available)
    for _ in range(iters):
        col = y.sum(axis=0)
        over = col > caps + 1e-9
        if not over.any():
            break
        scale = np.where(over, caps / np.maximum(col, 1e-12), 1.0)
        y = y * scale[None, :]
        y = project_rows_to_simplex(y, available)
    return y
