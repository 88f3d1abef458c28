"""The paper's cost model (§3), exact reference implementation.

Everything here is float64 numpy — this is the *oracle* (a copy of
``repro.core.costmodel`` kept by the PyTorch port, which imports nothing of
``repro``).  The port's batched torch twin lives in
:mod:`repro_torch.core.torchmodel`; tests assert the two agree on random
instances.

Paper formulas implemented:

  edgeLat(i→j) = max_{u∈ED_i} { x_{i,u}·s_i·Σ_{v∈ED_j} comCost_{u,v}·x_{j,v} }
                 + α·enabledLinks_{i,j}
  Latency      = max_{paths} Σ_{(i→j)∈path} edgeLat(i→j)
  F            = Latency / (1 + β·DQ_fraction)                       (eq. 8)

plus the §3.1 "trivial through simple sum functions" extensions (network
movement as in [26], device occupancy) and the compute-cost extension used by
auto-sharding (DESIGN.md assumption log).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.devices import ExplicitFleet, RegionFleet
from repro_torch.core.graph import OpGraph

__all__ = [
    "CostConfig",
    "edge_latency",
    "edge_latencies",
    "enabled_links",
    "latency",
    "latency_via_paths",
    "objective_F",
    "network_movement",
    "device_occupancy",
    "node_compute_cost",
]

Fleet = ExplicitFleet | RegionFleet


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Knobs of the cost model.

    alpha: the paper's network-congestion / connection-overhead factor.
    include_compute: enable the per-operator compute term (extension;
      False ⇒ paper-faithful "communication dominates" assumption).
    nz_eps: threshold under which a fraction counts as zero for
      ``enabledLinks`` (the paper uses exact ``x ≠ 0``).
    """

    alpha: float = 0.0
    include_compute: bool = False
    nz_eps: float = 0.0


def _com_times_x(fleet: Fleet, x_j: np.ndarray) -> np.ndarray:
    """(Σ_v comCost_{u,v} · x_{j,v}) for every u — structured when possible.

    RegionFleet path: comCost_{u,v} = d_u·d_v·inter[r_u, r_v] (u ≠ v), so the
    matvec collapses to a degrade-weighted region mass (segment sum) times
    the (R, R) inter matrix, plus a diagonal correction to self_cost —
    O(V + R²) instead of O(V²)."""
    if isinstance(fleet, RegionFleet):
        diag_r = np.diag(fleet.inter)[fleet.region]
        if fleet.degrade is None:  # healthy fleet — skip the no-op passes
            mass = fleet.region_masses(x_j)  # (R,)
            per_u = fleet.inter[fleet.region] @ mass  # (V,)
            per_u += (fleet.self_cost - diag_r) * x_j
            return per_u
        d = fleet.degrade
        mass = fleet.region_masses(d * x_j)  # (R,)
        per_u = d * (fleet.inter[fleet.region] @ mass)  # (V,)
        # u==v pairs were priced at d_u²·inter[r,r]; correct them to self_cost.
        per_u += (fleet.self_cost - d * d * diag_r) * x_j
        return per_u
    return fleet.com_cost @ x_j


def _effective_speed(fleet: Fleet, n_dev: int) -> np.ndarray:
    """(V,) compute speed with degrade applied — shared by the occupancy
    objective and the compute-cost extension so a straggler is priced slow
    on compute exactly as its links are priced slow (fleet.effective_speed,
    falling back to ones for speed-less fleets)."""
    if fleet.speed is None:
        return np.ones(n_dev)
    return fleet.effective_speed()


def enabled_links(x_i: np.ndarray, x_j: np.ndarray, nz_eps: float = 0.0) -> float:
    """#{(u,v): x_{i,u}≠0, x_{j,v}≠0, u≠v} — devices exchanging data over the net."""
    nz_i = x_i > nz_eps
    nz_j = x_j > nz_eps
    return float(nz_i.sum() * nz_j.sum() - (nz_i & nz_j).sum())


def edge_latency(
    x_i: np.ndarray,
    x_j: np.ndarray,
    s_i: float,
    fleet: Fleet,
    cfg: CostConfig = CostConfig(),
) -> float:
    """Paper edge latency: slowest single-device transfer + α·enabledLinks."""
    per_u = x_i * s_i * _com_times_x(fleet, x_j)
    base = float(per_u.max()) if per_u.size else 0.0
    if cfg.alpha:
        base += cfg.alpha * enabled_links(x_i, x_j, cfg.nz_eps)
    return base


def edge_latencies(graph: OpGraph, fleet: Fleet, x: np.ndarray,
                   cfg: CostConfig = CostConfig()) -> np.ndarray:
    """(E,) edge latency for every edge of the graph."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros(graph.n_edges)
    for e, (i, j) in enumerate(graph.edges):
        out[e] = edge_latency(x[i], x[j], graph.operators[i].selectivity, fleet, cfg)
    return out


def node_compute_cost(graph: OpGraph, fleet: Fleet, x: np.ndarray, i: int) -> float:
    """Extension: slowest instance's compute time for operator i.

    ``work_i · rate_i · x_{i,u} / speed_u`` maxed over devices that hold a
    fraction.  rate_i scales work by upstream selectivities.
    """
    op = graph.operators[i]
    if op.work == 0.0:
        return 0.0
    rate = graph.cumulative_rates()[i]
    t = op.work * rate * x[i] / _effective_speed(fleet, x.shape[1])
    return float(t.max())


def latency(graph: OpGraph, fleet: Fleet, x: np.ndarray,
            cfg: CostConfig = CostConfig()) -> float:
    """Critical-path latency by topological DP (== max over explicit paths).

    dist[j] = max_{i∈pred(j)} (dist[i] + edgeLat(i→j)) (+ compute terms when
    the extension is on); answer = max over sinks.
    """
    x = np.asarray(x, dtype=np.float64)
    elat = edge_latencies(graph, fleet, x, cfg)
    dist = np.zeros(graph.n_ops)
    if cfg.include_compute:
        for i in graph.sources:
            dist[i] = node_compute_cost(graph, fleet, x, i)
    for i in graph.topo_order:
        for j, e in graph.out_edges(i):
            cand = dist[i] + elat[e]
            if cfg.include_compute:
                cand += node_compute_cost(graph, fleet, x, j)
            if cand > dist[j]:
                dist[j] = cand
    sinks = graph.sinks
    return float(max(dist[s] for s in sinks)) if sinks else 0.0


def latency_via_paths(graph: OpGraph, fleet: Fleet, x: np.ndarray,
                      cfg: CostConfig = CostConfig()) -> float:
    """Oracle: explicit max over enumerated paths (exponential; tests only)."""
    elat = edge_latencies(graph, fleet, x, cfg)
    paths = graph.edge_paths()
    if not paths:
        return 0.0
    if cfg.include_compute:
        raise NotImplementedError("oracle covers the paper-faithful model only")
    return float(max((sum(elat[e] for e in p) for p in paths), default=0.0))


def objective_F(latency_value: float, dq_fraction: float, beta: float) -> float:
    """Paper eq. (8): quality-aware objective.  β=0 removes DQ from play."""
    if not 0.0 <= dq_fraction <= 1.0:
        raise ValueError(f"DQ_fraction must be in [0,1], got {dq_fraction}")
    if beta < 0.0:
        raise ValueError(f"beta must be ≥ 0, got {beta}")
    return latency_value / (1.0 + beta * dq_fraction)


# -- §3.1 additional objectives ("trivial through simple sum functions") -----

def network_movement(graph: OpGraph, fleet: Fleet, x: np.ndarray,
                     weight_by_cost: bool = False) -> float:
    """Total data moved over the network (as in [26]): Σ_edges Σ_{u≠v}
    rate_i·s_i·bytes_i·x_{i,u}·x_{j,v}, optionally weighted by comCost.

    The bilinear sum factorizes — unweighted it is
    ``(Σ_u x_{i,u})·(Σ_v x_{j,v}) − Σ_u x_{i,u}·x_{j,u}`` (O(V) per edge);
    weighted it routes through :func:`_com_times_x`, so RegionFleets take
    the degrade-weighted segment-sum path (O(V + R²) per edge) and never
    materialize ``com_matrix()``.  The u == v diagonal (data staying local)
    is subtracted explicitly in both forms.
    """
    x = np.asarray(x, dtype=np.float64)
    rates = graph.cumulative_rates()
    if weight_by_cost:
        # per-device self-transfer price: what _com_times_x puts on u == v
        diag = fleet.self_cost if isinstance(fleet, RegionFleet) \
            else np.diag(fleet.com_cost)
    total = 0.0
    for i, j in graph.edges:
        op = graph.operators[i]
        if weight_by_cost:
            pair = x[i] @ _com_times_x(fleet, x[j]) \
                - float(np.sum(x[i] * diag * x[j]))
        else:
            pair = float(x[i].sum() * x[j].sum() - np.sum(x[i] * x[j]))
        total += rates[i] * op.selectivity * op.out_bytes * pair
    return float(total)


def device_occupancy(graph: OpGraph, fleet: Fleet, x: np.ndarray) -> np.ndarray:
    """(V,) total processing time each device is occupied for one unit batch
    per source (§3.1: "total time resources are occupied").

    Speeds are *effective* speeds: a RegionFleet device with a ``degrade``
    multiplier occupies proportionally longer — the compute-side twin of how
    its links are priced ``degrade``× slower."""
    x = np.asarray(x, dtype=np.float64)
    rates = graph.cumulative_rates()
    speed = _effective_speed(fleet, x.shape[1])
    occ = np.zeros(x.shape[1])
    for i, op in enumerate(graph.operators):
        occ += op.work * rates[i] * x[i] / speed
    return occ
