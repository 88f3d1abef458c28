"""Featurization of devices and operators for the learned cost prior.

COSTREAM / Zero-Shot Cost Models (PAPERS.md) transfer learned cost models
to unseen configurations by featurizing operators and hardware instead of
keying on identities.  The same idea here: a device is described by its
speed tier and its region's link-cost profile, an operator by its
selectivity / payload / work and its position in the DAG — NEVER by its
index — so a prior fit on one generated fleet prices devices of a fleet it
has never seen.

Invariance contract (property-tested in ``tests/test_belief.py``): the
feature vector follows the device, not the index — reindexing devices
within a region permutes the feature rows by exactly the same permutation.
Every feature is therefore a function of device *values* (speed, region
aggregates), not of device ids.

numpy copy of ``repro.belief.features`` for the PyTorch port; every
feature matrix is bitwise equal to the reference's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DEVICE_FEATURES", "OP_FEATURES", "device_features", "op_features",
           "speed_percentile"]

#: Column names of :func:`device_features` (order is the contract).
DEVICE_FEATURES = (
    "log_speed",          # log effective speed (1.0 = nominal)
    "speed_percentile",   # rank of the device's speed within the fleet [0, 1]
    "tier_slow",          # bottom-third speed tier (cheap hardware class)
    "tier_mid",
    "tier_fast",
    "log_out_com",        # log mean com cost of the device's outgoing links
    "log_intra_com",      # log mean com cost within the device's region
    "region_frac",        # fraction of the fleet in the device's region
)

#: Column names of :func:`op_features`.
OP_FEATURES = (
    "log_selectivity",
    "log_out_bytes",
    "log1p_work",
    "log_cum_rate",       # rows reaching the op per source row (dataflow depth)
    "in_degree",
    "out_degree",
    "is_source",
    "is_sink",
    "dq_eligible",
)


def speed_percentile(speed: np.ndarray) -> np.ndarray:
    """Mid-rank percentile of each device's speed within the fleet — a pure
    function of the speed *multiset*, so it is invariant under any device
    permutation (ties share one value instead of splitting by index)."""
    s = np.asarray(speed, dtype=np.float64)
    below = (s[None, :] < s[:, None]).mean(axis=1)
    equal = (s[None, :] == s[:, None]).mean(axis=1)
    return below + 0.5 * equal


def device_features(fleet) -> np.ndarray:
    """(V, len(DEVICE_FEATURES)) feature matrix for a fleet (ExplicitFleet
    or RegionFleet — anything with ``effective_speed``/``com_matrix``/
    ``region``)."""
    speed = np.asarray(fleet.effective_speed(), dtype=np.float64)
    com = np.asarray(fleet.com_matrix(), dtype=np.float64)
    region = np.asarray(getattr(fleet, "region", None)
                        if getattr(fleet, "region", None) is not None
                        else np.zeros(speed.size, dtype=np.int64))
    v = speed.size
    pct = speed_percentile(speed)
    tier_slow = (pct < 1.0 / 3.0).astype(np.float64)
    tier_fast = (pct >= 2.0 / 3.0).astype(np.float64)
    tier_mid = 1.0 - tier_slow - tier_fast
    off = com.copy()
    np.fill_diagonal(off, 0.0)
    out_com = off.sum(axis=1) / max(v - 1, 1)
    intra_com = np.zeros(v)
    region_frac = np.zeros(v)
    for r in np.unique(region):
        mask = region == r
        n_r = int(mask.sum())
        region_frac[mask] = n_r / v
        if n_r > 1:
            block = off[np.ix_(mask, mask)]
            intra_com[mask] = block.sum() / (n_r * (n_r - 1))
        else:
            intra_com[mask] = 0.0
    feats = np.stack([
        np.log(np.maximum(speed, 1e-12)),
        pct,
        tier_slow,
        tier_mid,
        tier_fast,
        np.log1p(out_com),
        np.log1p(intra_com),
        region_frac,
    ], axis=1)
    return feats


def op_features(graph) -> np.ndarray:
    """(n_ops, len(OP_FEATURES)) feature matrix for an OpGraph."""
    n = graph.n_ops
    in_deg = np.zeros(n)
    out_deg = np.zeros(n)
    for a, b in graph.edges:
        out_deg[a] += 1.0
        in_deg[b] += 1.0
    cum = np.asarray(graph.cumulative_rates(), dtype=np.float64)
    feats = np.stack([
        np.array([np.log(max(op.selectivity, 1e-12))
                  for op in graph.operators]),
        np.array([np.log(max(op.out_bytes, 1e-12))
                  for op in graph.operators]),
        np.array([np.log1p(max(op.work, 0.0)) for op in graph.operators]),
        np.log(np.maximum(cum, 1e-12)),
        in_deg,
        out_deg,
        (in_deg == 0).astype(np.float64),
        (out_deg == 0).astype(np.float64),
        np.array([float(getattr(op, "dq_eligible", False))
                  for op in graph.operators]),
    ], axis=1)
    return feats
