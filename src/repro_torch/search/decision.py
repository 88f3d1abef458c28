"""Decision helpers the serving layer applies to scored grids — the part of
``repro.search.decision`` that the single-objective slice of the PyTorch
port uses, copied (the port imports nothing of ``repro``):

  * :func:`robust_select`   — min–max: worst scenario per candidate, argmin
    over candidates;
  * :func:`split_dq_term`   — a raw (dq = 0, β = 0) grid as
    ``rest + w_lat·lat/(1 + β·dq)``;
  * :func:`dq_caps_mask`    — vectorized DQCoupling feasibility;
  * :func:`joint_dq_scores` — per-(scenario, candidate) dq co-optimization.

Pareto extraction, ε-constraint selection and objective normalization work
on the per-objective grids and come with the multi-objective slice.
Everything here is plain numpy on already-computed host grids.  All
objectives are minimized.
"""

from __future__ import annotations

import numpy as np

__all__ = ["robust_select", "split_dq_term", "dq_caps_mask",
           "joint_dq_scores"]


def robust_select(grid: np.ndarray) -> tuple[int, np.ndarray]:
    """Min–max over an (S, P) score grid: returns (argmin candidate index,
    (P,) worst-case scores).  First occurrence wins ties."""
    g = np.asarray(grid, dtype=np.float64)
    worst = g.max(axis=0)
    return int(np.argmin(worst)), worst


def split_dq_term(raw_result):
    """Split a RAW ``score_grid`` result (dispatched at dq = 0, β = 0) into
    ``(lat, rest, w_lat)`` with ``score = rest + w_lat·lat/(1 + β·dq)``.

    Only latency-F depends on dq (paper eq. 8).  ``raw_result`` is the plain
    latency grid (rest = 0, w_lat = 1) or an object with ``grids`` /
    ``scalarized`` / ``names`` / ``weights`` (the reference's
    ``ObjectiveGrids``)."""
    if not hasattr(raw_result, "grids"):
        lat = np.asarray(raw_result, dtype=np.float64)
        return lat, np.zeros_like(lat), 1.0
    scal = np.asarray(raw_result.scalarized, dtype=np.float64)
    w_lat = dict(zip(raw_result.names,
                     raw_result.weights)).get("latency_f", 0.0)
    if "latency_f" in raw_result.names:
        lat = np.asarray(raw_result.grids["latency_f"], dtype=np.float64)
    else:
        lat = np.zeros_like(scal)
    return lat, scal - w_lat * lat, w_lat


def dq_caps_mask(placements, dq_values, coupling,
                 atol: float = 1e-7) -> np.ndarray | None:
    """(P, D) DQCoupling feasibility: per-device column mass ≤
    cap0 − dq·load.  None coupling ⇒ None (everything feasible)."""
    if coupling is None:
        return None
    col = np.asarray(placements, dtype=np.float64).sum(axis=1)   # (P, V)
    dq_values = np.atleast_1d(np.asarray(dq_values, dtype=np.float64))
    caps = (np.asarray(coupling.cap0, dtype=np.float64)[None, :]
            - dq_values[:, None]
            * np.asarray(coupling.load, dtype=np.float64)[None, :])
    return (col[:, None, :] <= caps[None, :, :] + atol).all(axis=-1)


def joint_dq_scores(lat: np.ndarray, dq_values: np.ndarray, beta: float,
                    rest: np.ndarray | None = None, w_lat: float = 1.0,
                    feasible: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Co-optimize ``dq_fraction`` per (scenario, candidate) cell.

    ``lat`` is the raw (S, P) latency grid; the (S, P, D) score tensor
    ``rest + w_lat·lat/(1 + β·dq_d)`` is expanded analytically, ``feasible``
    ((P, D)) masks infeasible pairs with +inf, and each cell keeps its best
    dq.  Returns ``(scores (S, P), dq_idx (S, P))``."""
    lat = np.asarray(lat, dtype=np.float64)
    dq_values = np.asarray(dq_values, dtype=np.float64)
    denom = 1.0 + float(beta) * dq_values                    # (D,)
    cube = w_lat * lat[:, :, None] / denom[None, None, :]    # (S, P, D)
    if rest is not None:
        cube = cube + np.asarray(rest, dtype=np.float64)[:, :, None]
    if feasible is not None:
        cube = np.where(np.asarray(feasible, dtype=bool)[None, :, :],
                        cube, np.inf)
    dq_idx = np.argmin(cube, axis=2)
    return np.take_along_axis(cube, dq_idx[:, :, None], axis=2)[:, :, 0], \
        dq_idx
