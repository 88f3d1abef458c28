"""Carry the reference's objects across to the port.

The port imports nothing of ``repro``, so its graph and fleet objects are
rebuilt from plain numpy arrays and Python scalars — what
``repro.core.OpGraph`` / ``repro.core.RegionFleetFamily`` hold and what the
reference's ``pack_fleets`` returns.  With these a test (or a user moving
a deployment across) feeds one graph and one fleet to both packages.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.devices import RegionFleetFamily
from repro_torch.core.graph import Operator, OpGraph

__all__ = ["graph_from_arrays", "region_family_from_arrays",
           "dense_pack_from_array"]


def graph_from_arrays(names, selectivity, out_bytes, work, dq_eligible,
                      edges) -> OpGraph:
    """An :class:`OpGraph` from per-operator columns and an (E, 2) edge
    list (pairs of operator indices)."""
    cols = [list(names), np.asarray(selectivity, dtype=np.float64),
            np.asarray(out_bytes, dtype=np.float64),
            np.asarray(work, dtype=np.float64),
            np.asarray(dq_eligible, dtype=bool)]
    if len({len(c) for c in cols}) != 1:
        raise ValueError("operator columns disagree on length: "
                         f"{[len(c) for c in cols]}")
    ops = [Operator(name=str(n), selectivity=float(s), out_bytes=float(b),
                    work=float(w), dq_eligible=bool(q))
           for n, s, b, w, q in zip(*cols)]
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return OpGraph(ops, [tuple(e) for e in edges.tolist()])


def region_family_from_arrays(region, inter, degrade, self_cost,
                              speed=None) -> RegionFleetFamily:
    """A :class:`RegionFleetFamily` from its (V,) region ids, (S, R, R)
    inter costs, (S, V) degrade multipliers, self cost and optional speeds
    ((V,) or (S, V))."""
    return RegionFleetFamily(
        region=np.array(region, dtype=np.int64),
        inter=np.array(inter, dtype=np.float64),
        degrade=np.array(degrade, dtype=np.float64),
        self_cost=float(self_cost),
        speed=None if speed is None else np.array(speed, dtype=np.float64))


def dense_pack_from_array(coms) -> np.ndarray:
    """A dense (S, V, V) float32 scenario pack, validated square."""
    arr = np.array(coms, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
        raise ValueError(f"dense pack must be (S, V, V), got {arr.shape}")
    return arr
