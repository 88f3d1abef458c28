"""Query normalization and shape bucketing for the what-if serving layer —
the PyTorch port's copy of ``repro.serve.bucketing``.

Heterogeneous tenant queries coalesce only when they can share a dispatch:

  * **dq/β are analytic, not dispatched.**  Every query is dispatched RAW
    (dq = 0, β = 0): only latency-F depends on dq, through the closed-form
    ``/(1 + β·dq)`` factor, so queries with *different* dq values, dq grids
    and β coexist in one super-batch and get their own finish on the host
    afterwards (:func:`finish_scores`).
  * **rows are independent.**  ``score_grid`` treats placement rows
    independently, so concatenating tenants' candidate rows — and padding
    with repeated rows up to a power-of-two bucket — changes nothing about
    any individual row's result.

What remains in the coalescing key is what the dispatch pins: the
evaluator family (graph content + CostConfig + device), the scenario pack
(content digest — two tenants registering equal fleets coalesce), and the
objective set.  The padded row count is the *shape bucket*: the unit of
admission pricing and per-bucket telemetry.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.costmodel import CostConfig
from repro_torch.core.devices import RegionFleetFamily
from repro_torch.sim.batched import dq_denominator as sim_dq_denominator
from repro_torch.sim.execache import graph_key

__all__ = ["CoalesceKey", "dq_denominator", "fleet_digest", "next_pow2",
           "pad_rows", "finish_scores"]


def next_pow2(n: int) -> int:
    """Next power of two ≥ n: a handful of padded shapes instead of one per
    row count."""
    return 1 << max(int(n) - 1, 0).bit_length()


def fleet_digest(pack, speed=None) -> str:
    """Content digest of a packed scenario family (dense (S, V, V) stack or
    :class:`RegionFleetFamily`), and of a dense pack's (S, V) ``speed``
    when one is registered with it.  Computed ONCE at fleet registration —
    queries then carry the fleet id — so coalescing across tenants keys on
    what the dispatch actually consumes, not on object identity."""
    h = hashlib.sha256()
    if speed is not None:
        h.update(b"speed")
        h.update(np.ascontiguousarray(speed, dtype=np.float32).tobytes())
    if isinstance(pack, RegionFleetFamily):
        h.update(b"structured")
        h.update(np.ascontiguousarray(pack.region).tobytes())
        h.update(np.ascontiguousarray(pack.inter).tobytes())
        h.update(np.ascontiguousarray(pack.degrade).tobytes())
        h.update(np.float64(pack.self_cost).tobytes())
        h.update(np.ascontiguousarray(pack.speed_or_ones()).tobytes())
    else:
        arr = np.asarray(pack, dtype=np.float32)
        if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
            raise ValueError(f"dense pack must be (S, V, V), "
                             f"got {arr.shape}")
        h.update(b"dense")
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class CoalesceKey:
    """Everything two queries must agree on to share one raw dispatch.

    ``graph`` / ``cfg`` / ``device`` pin the evaluator family (``device``
    takes the place of the reference's two pallas flags), ``fleet`` (the
    registration-time content digest) pins the scenario operands,
    ``objectives`` the objective set (None = the single-objective latency
    grid); the fleet id of a set-registered fleet carries the set's hash
    as well, so two sets on one pack never share a key.  dq/β are
    deliberately ABSENT —
    they are applied analytically per query after the dispatch."""

    graph: tuple
    cfg: CostConfig
    device: str
    fleet: str
    objectives: object | None

    @classmethod
    def of(cls, graph, cfg: CostConfig, device, fleet_id: str,
           objectives=None) -> "CoalesceKey":
        return cls(graph=graph_key(graph), cfg=cfg, device=str(device),
                   fleet=fleet_id, objectives=objectives)


def pad_rows(xs: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a (P, n_ops, V) super-batch to ``bucket`` rows by repeating the
    last row.  Padding rows are real (valid simplex placements), score
    normally, and are SLICED OFF before any tenant sees results — the
    non-leak property ``tests/test_serve.py`` pins."""
    pad = bucket - xs.shape[0]
    if pad < 0:
        raise ValueError(f"batch of {xs.shape[0]} rows exceeds "
                         f"bucket {bucket}")
    if pad == 0:
        return xs
    return np.concatenate([xs, np.repeat(xs[-1:], pad, axis=0)])


def dq_denominator(dq, beta: float, n_scenarios: int) -> np.ndarray:
    """The (S, 1) float32 column ``1 + β·dq``, rounded ONCE by the same
    function a direct ``score_grid`` uses
    (:func:`repro_torch.sim.batched.dq_denominator`: the f32×f32 product is
    exact in float64 and the +1 rounds once to f32 — the value the
    reference's fused multiply-add gives; numpy's two-rounding
    ``f32(f32(β·dq) + 1)`` misses it by 1 ulp on ~⅓ of operands), so the
    host finish divides by the bitwise-same denominator."""
    return sim_dq_denominator(dq, beta, n_scenarios)[:, None]


def finish_scores(lat: np.ndarray, rest: np.ndarray, w_lat: float,
                  dq, beta: float) -> np.ndarray:
    """Apply one query's dq/β finish to its slice of the raw grids:
    ``rest + w_lat · lat / (1 + β·dq)`` with dq a scalar or per-scenario
    (S,) column.

    Arithmetic is float32 in the dispatch's own op order (see
    :func:`dq_denominator`) — so a served single-objective score is BITWISE
    what a direct ``score_grid(..., dq=dq, beta=beta)`` computes on the
    device (IEEE-754 divide is exactly rounded on both sides; gated in
    ``tests/test_torch_serve.py`` and ``chip_smoke.py``)."""
    lat32 = np.asarray(lat, dtype=np.float32)
    denom = dq_denominator(dq, beta, lat32.shape[0])
    # w_lat = 1 / rest = 0 (the single-objective path) are bitwise no-ops:
    # ×1.0f and +0.0f are exact, so this one expression serves both cases
    return np.asarray(rest, dtype=np.float32) \
        + np.float32(w_lat) * lat32 / denom
