"""The unified multi-objective cost layer (paper §3.1) on PyTorch — the
port of ``repro.core.objectives``.

One :class:`ObjectiveSpec` per objective bundles

  * ``scalar``            — the float64 numpy oracle
    (:mod:`repro_torch.core.costmodel`);
  * ``build_dense``       — ``(graph, cfg, device) -> f(x, com, speed)``:
    x (P, n_ops, V) placements against one scenario's (V, V) com and (V,)
    effective speeds → (P,) raw values;
  * ``build_structured``  — ``(graph, region, n_regions, self_cost, cfg,
    device) -> f(x, inter, degrade, speed)``: one RegionFleetFamily
    scenario's (R, R) inter, (V,) degrade and (V,) NOMINAL speeds → (P,)
    raw values, never a (V, V) array;
  * ``finish``            — ``(raw, dq, beta) -> value``, applied to the
    whole (S, P) grid after the scenario loop (only latency-F uses it:
    paper eq. 8's ``/(1 + β·dq)``).

Unlike the reference's twins, which score one placement and are
``vmap``-ed, the batched twins here take the placement batch as a leading
P axis.  An :class:`ObjectiveSet` bundles specs with scalarization weights;
``BatchedEvaluator.score_grid(objectives=...)`` returns every objective's
(S, P) grid and the weighted sum as an :class:`ObjectiveGrids`.

Objectives (weights are the caller's unit exchange rates; the objectives
are not normalized here — ``repro_torch.search.decision.ObjectiveScales``
does that):

  ``latency_f``             critical-path latency / (1 + β·dq)
  ``network_movement``      Σ_edges rate·s·bytes·Σ_{u≠v} x_iu·x_jv
  ``network_movement_cost`` the same sum, each (u, v) pair weighted by
                            comCost_{u,v}
  ``occupancy_max``         max_u of §3.1 device occupancy
  ``occupancy_imbalance``   max_u − mean_u occupancy

Two choices of the port:

* The structured cost-weighted movement forms its (P, n_ops, R) region
  masses as a product with the fixed degrade-weighted one-hot matrix
  (:func:`repro_torch.core.torchmodel.region_mass`), not with a scatter:
  ``index_add_`` on CUDA accumulates with atomics in an order that changes
  from run to run.
* The dense cost-weighted movement's ``x @ comᵀ`` and the structured mass
  product are plain matrix products (cuBLAS on the card) and must run in
  full FP32: TF32 misses the 1e-5 bar, so they raise when TF32 matmuls
  are enabled.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.costmodel import (CostConfig, device_occupancy,
                                        latency, network_movement,
                                        objective_F)
from repro_torch.core.devices import ExplicitFleet, RegionFleet
from repro_torch.core.graph import OpGraph
from repro_torch.core.torchmodel import (_edge_tensors, critical_path_dp,
                                         make_edge_latencies_com_fn,
                                         make_edge_latencies_region_fn,
                                         region_mass, region_onehot,
                                         require_fp32_matmul)
from repro_torch.kernels import dispatch

__all__ = [
    "ObjectiveSpec",
    "ObjectiveSet",
    "ObjectiveGrids",
    "OBJECTIVES",
    "as_objective_set",
]

Fleet = ExplicitFleet | RegionFleet


# -- static per-graph vectors shared by the twins -----------------------------

def _edge_movement_weights(graph: OpGraph) -> np.ndarray:
    """(E,) rate_i·s_i·bytes_i for every edge (i → j) — the §3.1 movement
    weight of one unit of (u ≠ v) placement mass product."""
    rates = graph.cumulative_rates()
    return np.array([rates[i] * graph.operators[i].selectivity
                     * graph.operators[i].out_bytes
                     for i, _ in graph.edges], dtype=np.float64)


def _op_loads(graph: OpGraph) -> np.ndarray:
    """(n_ops,) work_i·rate_i — occupancy seconds per unit placement mass
    at unit speed."""
    rates = graph.cumulative_rates()
    return np.array([op.work * rates[i]
                     for i, op in enumerate(graph.operators)],
                    dtype=np.float64)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


# -- latency-F ----------------------------------------------------------------

def _scalar_latency_f(graph, fleet, x, dq, beta, cfg):
    return objective_F(latency(graph, fleet, x, cfg), dq, beta)


def _dense_latency_f(graph: OpGraph, cfg: CostConfig, device=None):
    elat = make_edge_latencies_com_fn(graph, cfg.alpha, cfg.nz_eps, device)

    def f(x, com, speed):
        return critical_path_dp(graph, elat(x, com[None]))

    return f


def _structured_latency_f(graph, region, n_regions, self_cost, cfg,
                          device=None):
    elat = make_edge_latencies_region_fn(graph, region, n_regions, self_cost,
                                         cfg.alpha, cfg.nz_eps, device)

    def f(x, inter, degrade, speed):
        return critical_path_dp(graph, elat(x, inter[None], degrade[None]))

    return f


def _finish_latency_f(raw, dq, beta):
    """Paper eq. 8 grid-wide (dq a scalar or (S, 1)): the denominator
    ``1 + β·dq`` is rounded ONCE to float32 — the f32×f32 product is exact
    in float64 — the value ``repro_torch.sim.batched.dq_denominator`` and
    the serving layer's host finish divide by."""
    dq = torch.as_tensor(dq, device=raw.device).to(torch.float32)
    beta = float(np.float32(beta))
    denom = (dq.to(torch.float64) * beta + 1.0).to(raw.dtype)
    return raw / denom


# -- network movement ---------------------------------------------------------

def _make_scalar_movement(weighted: bool):
    def scalar(graph, fleet, x, dq, beta, cfg):
        return network_movement(graph, fleet, x, weight_by_cost=weighted)

    return scalar


def _pair_mass(x, src, dst) -> torch.Tensor:
    """(P, E) Σ_{u≠v} x_iu·x_jv = Σx_i·Σx_j − Σ_u x_iu·x_ju."""
    tot = x.sum(-1)                                          # (P, n_ops)
    return tot[:, src] * tot[:, dst] - (x[:, src] * x[:, dst]).sum(-1)


def _make_dense_movement(weighted: bool):
    def build(graph: OpGraph, cfg: CostConfig, device=None):
        device = dispatch.resolve_device(device)
        src, dst, _ = _edge_tensors(graph, device)
        w = _f32(_edge_movement_weights(graph), device)

        def f(x, com, speed):
            if not weighted:
                return _pair_mass(x, src, dst) @ w
            # price each OPERATOR's inbound transfer once (n·V² instead of
            # E·V²), then gather per edge
            require_fp32_matmul(x, "the movement objectives")
            op_t = torch.matmul(x, com.T)                    # (P, n_ops, V)
            diag = torch.diagonal(com)
            x_i = x[:, src]                                  # (P, E, V)
            pair = (x_i * op_t[:, dst]).sum(-1) \
                - (x_i * diag * x[:, dst]).sum(-1)
            return pair @ w

        return f

    return build


def _make_structured_movement(weighted: bool):
    def build(graph, region, n_regions, self_cost, cfg, device=None):
        device = dispatch.resolve_device(device)
        src, dst, _ = _edge_tensors(graph, device)
        w = _f32(_edge_movement_weights(graph), device)
        region_ix = torch.as_tensor(np.asarray(region, dtype=np.int64),
                                    device=device)
        onehot = region_onehot(region_ix, n_regions)

        def f(x, inter, degrade, speed):
            if not weighted:
                return _pair_mass(x, src, dst) @ w
            # Σ_{u≠v} d_u·d_v·inter[r_u,r_v]·x_iu·x_jv as a degrade-weighted
            # region-mass quadratic form minus the u == v diagonal, with the
            # (P, n_ops, R) masses formed ONCE per placement batch; the
            # quadratic form is a cuBLAS float32 product too
            require_fp32_matmul(x, "the movement objectives")
            mass = region_mass(x, degrade[None], onehot)     # (P, n_ops, R)
            quad = torch.einsum("per,rq,peq->pe", mass[:, src], inter,
                                mass[:, dst])
            diag = degrade * degrade * torch.diagonal(inter)[region_ix]
            pair = quad - (x[:, src] * diag * x[:, dst]).sum(-1)
            return pair @ w

        return f

    return build


# -- device occupancy ---------------------------------------------------------

def _make_scalar_occupancy(reduce: str):
    def scalar(graph, fleet, x, dq, beta, cfg):
        occ = device_occupancy(graph, fleet, x)
        if reduce == "max":
            return float(occ.max(initial=0.0))
        return float(occ.max(initial=0.0) - (occ.mean() if occ.size else 0.0))

    return scalar


def _occ_reduce(occ: torch.Tensor, reduce: str) -> torch.Tensor:
    """(P, V) occupancy → (P,) max, or max − mean."""
    if reduce == "max":
        return occ.amax(-1)
    return occ.amax(-1) - occ.mean(-1)


def _make_dense_occupancy(reduce: str):
    def build(graph: OpGraph, cfg: CostConfig, device=None):
        wk = _f32(_op_loads(graph), dispatch.resolve_device(device))

        def f(x, com, speed):
            occ = (wk[:, None] * x).sum(-2) / speed           # (P, V)
            return _occ_reduce(occ, reduce)

        return f

    return build


def _make_structured_occupancy(reduce: str):
    def build(graph, region, n_regions, self_cost, cfg, device=None):
        wk = _f32(_op_loads(graph), dispatch.resolve_device(device))

        def f(x, inter, degrade, speed):
            # effective speed = speed / degrade: a straggler's compute slows
            # by the multiplier that prices its links
            occ = (wk[:, None] * x).sum(-2) * degrade / speed
            return _occ_reduce(occ, reduce)

        return f

    return build


# -- the spec and its registry ------------------------------------------------

def _finish_identity(raw, dq, beta):
    return raw


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """One §3.1 objective, all representations in one place.

    ``scalar(graph, fleet, x, dq, beta, cfg) -> float`` returns the FINISHED
    value (dq/beta applied where relevant); the batched builders return the
    raw (P,) values of one scenario and ``finish(raw, dq, beta)`` is
    applied to the stacked (S, P) grid (dq arrives (S, 1)).
    """

    name: str
    scalar: Callable
    build_dense: Callable       # (graph, cfg, device) -> f(x, com, speed)
    build_structured: Callable  # (graph, region, R, self_cost, cfg, device) -> f(x, inter, degrade, speed)
    finish: Callable = _finish_identity


OBJECTIVES: dict[str, ObjectiveSpec] = {
    spec.name: spec
    for spec in (
        ObjectiveSpec(
            name="latency_f",
            scalar=_scalar_latency_f,
            build_dense=_dense_latency_f,
            build_structured=_structured_latency_f,
            finish=_finish_latency_f,
        ),
        ObjectiveSpec(
            name="network_movement",
            scalar=_make_scalar_movement(False),
            build_dense=_make_dense_movement(False),
            build_structured=_make_structured_movement(False),
        ),
        ObjectiveSpec(
            name="network_movement_cost",
            scalar=_make_scalar_movement(True),
            build_dense=_make_dense_movement(True),
            build_structured=_make_structured_movement(True),
        ),
        ObjectiveSpec(
            name="occupancy_max",
            scalar=_make_scalar_occupancy("max"),
            build_dense=_make_dense_occupancy("max"),
            build_structured=_make_structured_occupancy("max"),
        ),
        ObjectiveSpec(
            name="occupancy_imbalance",
            scalar=_make_scalar_occupancy("imbalance"),
            build_dense=_make_dense_occupancy("imbalance"),
            build_structured=_make_structured_occupancy("imbalance"),
        ),
    )
}


@dataclasses.dataclass(frozen=True)
class ObjectiveSet:
    """Objectives plus scalarization weights — the multi-objective knob.

    Hashable (the batched evaluator caches its builders per set).  Weights
    are exchange rates between objective units, NOT a convex combination:
    ``scalarized = Σ_k w_k · objective_k``.
    """

    specs: tuple[ObjectiveSpec, ...]
    weights: tuple[float, ...]

    def __post_init__(self):
        if len(self.specs) != len(self.weights):
            raise ValueError(
                f"{len(self.specs)} objectives but {len(self.weights)} weights")
        if not self.specs:
            raise ValueError("ObjectiveSet needs at least one objective")
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objectives: {names}")

    @classmethod
    def of(cls, *objectives: str | ObjectiveSpec,
           weights: Iterable[float] | None = None) -> "ObjectiveSet":
        """``ObjectiveSet.of("latency_f", "network_movement")`` — names
        resolve through :data:`OBJECTIVES`; weights default to all-ones."""
        specs = tuple(o if isinstance(o, ObjectiveSpec) else _lookup(o)
                      for o in objectives)
        w = tuple(1.0 for _ in specs) if weights is None \
            else tuple(float(v) for v in weights)
        return cls(specs=specs, weights=w)

    @classmethod
    def from_weights(cls, **name_weights: float) -> "ObjectiveSet":
        """``ObjectiveSet.from_weights(latency_f=1.0, network_movement=0.01)``."""
        return cls.of(*name_weights.keys(),
                      weights=tuple(name_weights.values()))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    # -- scalar (float64 oracle) path ----------------------------------------
    def scalar_values(self, graph: OpGraph, fleet: Fleet, x: np.ndarray,
                      dq: float = 0.0, beta: float = 0.0,
                      cfg: CostConfig = CostConfig()) -> dict[str, float]:
        """Every objective's exact value for one placement on one fleet."""
        return {s.name: float(s.scalar(graph, fleet, x, dq, beta, cfg))
                for s in self.specs}

    def scalar_total(self, graph: OpGraph, fleet: Fleet, x: np.ndarray,
                     dq: float = 0.0, beta: float = 0.0,
                     cfg: CostConfig = CostConfig()) -> float:
        """The weighted scalarization through the exact oracles."""
        vals = self.scalar_values(graph, fleet, x, dq, beta, cfg)
        return float(sum(w * vals[s.name]
                         for s, w in zip(self.specs, self.weights)))


def _lookup(name: str) -> ObjectiveSpec:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown objective {name!r}; "
                         f"choose from {sorted(OBJECTIVES)}") from None


def as_objective_set(objectives) -> ObjectiveSet:
    """Coerce user input — an ObjectiveSet, one name/spec, or a sequence of
    names/specs (unit weights) — into an ObjectiveSet."""
    if isinstance(objectives, ObjectiveSet):
        return objectives
    if isinstance(objectives, (str, ObjectiveSpec)):
        return ObjectiveSet.of(objectives)
    return ObjectiveSet.of(*objectives)


@dataclasses.dataclass
class ObjectiveGrids:
    """score_grid's multi-objective result: per-objective (S, P) grids and
    their weighted scalarization — float32 tensors on the evaluator's
    device, or numpy arrays after :meth:`to_host`."""

    names: tuple[str, ...]
    grids: dict
    scalarized: object
    weights: tuple[float, ...]

    def __getitem__(self, name: str):
        return self.grids[name]

    def to_host(self) -> "ObjectiveGrids":
        """The same grids as float32 numpy arrays, in ONE device→host
        transfer: the grids and the scalarization are stacked on the device
        first."""
        host = torch.stack([self.grids[n] for n in self.names]
                           + [self.scalarized]).cpu().numpy()
        return ObjectiveGrids(names=self.names,
                              grids={n: host[k]
                                     for k, n in enumerate(self.names)},
                              scalarized=host[-1], weights=self.weights)
