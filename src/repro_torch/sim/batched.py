"""Batched what-if evaluation on PyTorch: score (scenario × placement) grids
— the port of ``repro.sim.batched``.

Two scenario representations behind one API, as in the reference:

  * **dense** — a stacked (S, V, V) com pack (:func:`pack_fleets`); the
    bilinear max runs in the dense CUDA kernel (K1).  Memory O(S·V²).
  * **structured** — a :class:`~repro_torch.core.devices.RegionFleetFamily`
    (shared region layout, (S, R, R) inter, (S, V) degrade); the region
    factors are precomputed and the max runs in the structured kernel (K2).
    Never an (S, V, V) tensor, so grids reach 10⁵-device fleets.

``score_grid`` forms the cross product without replicating operands: the
scenario-independent endpoint rows x_i/x_j (and the α·enabledLinks term)
are gathered ONCE per call, then a Python loop over scenarios scores all P
placements against one shared (1, V, V) com or one (1, R, R) + (1, V)
family slice — the counterpart of the reference's ``lax.map``.  The
critical-path DP then runs once over the stacked (S, P, E) latencies.

With ``objectives=`` (an :class:`~repro_torch.core.objectives.ObjectiveSet`)
the same call returns every objective's (S, P) grid and their weighted
scalarization as an :class:`~repro_torch.core.objectives.ObjectiveGrids`.
``latency_f`` keeps the launch pattern above (one K1/K2 launch per
scenario, one DP); the other objectives score all P placements at once
per scenario through their spec's batched twin, and dq/β (``finish``) and
the weighted sum apply to the stacked grids.

Tensors live on the evaluator's ``device``: ``None`` means the card and
raises without CUDA; ``device="cpu"`` runs the kernels' plain versions
(the tests' route).  Placements and packs may arrive as numpy arrays or
tensors and are moved to the device once per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis import sanitize
from repro_torch.core.costmodel import CostConfig
from repro_torch.core.devices import ExplicitFleet, RegionFleet, \
    RegionFleetFamily
from repro_torch.core.graph import OpGraph
from repro_torch.core.objectives import (ObjectiveGrids, ObjectiveSet,
                                         as_objective_set)
from repro_torch.core.torchmodel import (_edge_tensors, critical_path_dp,
                                         edge_endpoints, links_term,
                                         make_edge_latencies_com_fn,
                                         region_onehot,
                                         structured_edge_latency)
from repro_torch.kernels import dispatch
from repro_torch.sim.execache import ExecutableCache, executable_cache, \
    graph_key

__all__ = ["BatchedEvaluator", "pack_fleets", "pack_placements",
           "pack_region_fleets", "pack_speeds", "dq_denominator"]

# instance memo behind BatchedEvaluator.shared(): one evaluator per
# (graph content, cfg, device), so the serving layer and scripts converge on
# the same instance and its per-layout state
_shared_evaluators = ExecutableCache(capacity=64, name="evaluators")

Fleet = ExplicitFleet | RegionFleet


def pack_fleets(fleets: list[Fleet]) -> np.ndarray:
    """(S, V, V) float32 stacked com matrices — the DENSE scenario pack."""
    mats = [np.asarray(f.com_matrix(), dtype=np.float64) for f in fleets]
    shapes = {m.shape for m in mats}
    if len(shapes) != 1:
        raise ValueError(f"fleets disagree on device count: {sorted(shapes)}")
    return np.stack(mats).astype(np.float32)


def pack_region_fleets(fleets: list[RegionFleet]) -> RegionFleetFamily:
    """Pack RegionFleets sharing one region layout into the STRUCTURED
    scenario representation (no (S, V, V) materialization anywhere)."""
    if not all(isinstance(f, RegionFleet) for f in fleets):
        raise ValueError("pack_region_fleets needs RegionFleets; "
                         "use pack_fleets for mixed/dense fleets")
    return RegionFleetFamily.from_fleets(fleets)


def pack_placements(xs: list[np.ndarray]) -> np.ndarray:
    """(P, n_ops, V) float32 stacked candidate placements."""
    return np.stack([np.asarray(x) for x in xs]).astype(np.float32)


def pack_speeds(fleets: list[Fleet]) -> np.ndarray:
    """(S, V) float32 stacked *effective* device speeds — the dense-path
    companion of :func:`pack_fleets` for the occupancy objectives (the com
    stack carries link state only).  Structured families carry their own
    speeds."""
    sp = [np.asarray(f.effective_speed(), dtype=np.float64) for f in fleets]
    shapes = {s.shape for s in sp}
    if len(shapes) != 1:
        raise ValueError(f"fleets disagree on device count: {sorted(shapes)}")
    return np.stack(sp).astype(np.float32)


def dq_denominator(dq, beta: float, n: int) -> np.ndarray:
    """(n,) float32 ``1 + β·dq`` rounded ONCE: the float32 product is exact
    in float64 and the +1 rounds once on the cast — the same value the
    reference's fused multiply-add gives, and the same value the serving
    layer's host finish divides by (``repro_torch.serve.bucketing``), so
    served scores are bitwise equal to a direct ``score_grid``."""
    dq32 = np.broadcast_to(np.asarray(dq, dtype=np.float32), (n,))
    return (np.float64(np.float32(beta)) * dq32.astype(np.float64)
            + 1.0).astype(np.float32)


@dataclasses.dataclass
class _Layout:
    """Device state of one structured family layout (static structure,
    like the graph): the region index and its (V, R) one-hot."""

    region_ix: torch.Tensor
    onehot: torch.Tensor
    self_cost: float


@dataclasses.dataclass
class BatchedEvaluator:
    """Batched twin of edge_latencies / latency / objective_F for one graph.

    ``com`` is a dense (B, V, V) stack (or (1, V, V) shared) or a
    RegionFleetFamily with 1 or B scenarios; ``x`` is (B, n, V):

      edge_latencies(x, com)                -> (B, E)
      latency(x, com)                       -> (B,)
      objective(x, com, dq, beta)           -> (B,)
      score_grid(x (P,n,V), com [S scen])   -> (S, P)

    Results are float32 tensors on ``device``.
    """

    graph: OpGraph
    cfg: CostConfig = CostConfig()
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = dispatch.resolve_device(self.device)
        if self.cfg.include_compute:
            raise NotImplementedError(
                "batched evaluator covers the paper-faithful model "
                "(communication dominates); compute extension is scalar-only")
        self._src, self._dst, self._sel = _edge_tensors(self.graph,
                                                        self.device)
        self._elat_dense = make_edge_latencies_com_fn(
            self.graph, self.cfg.alpha, self.cfg.nz_eps, self.device)
        self._eval_key = (graph_key(self.graph), self.cfg, str(self.device))

    @classmethod
    def shared(cls, graph: OpGraph, cfg: CostConfig = CostConfig(),
               device=None) -> "BatchedEvaluator":
        """The process-shared evaluator for this (graph, cfg, device) —
        equal-content graphs map to the SAME instance.  The device resolves
        before the memo key, so ``None`` and its resolution share one."""
        dev = dispatch.resolve_device(device)
        key = ("evaluator", graph_key(graph), cfg, str(dev))
        return _shared_evaluators.get_or_build(
            key, lambda: cls(graph, cfg, device=dev))

    # -- operands ------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        """float32, contiguous (the kernels take no strided views), on the
        evaluator's device; a no-op for a tensor that already is."""
        return torch.as_tensor(a, dtype=torch.float32,
                               device=self.device).contiguous()

    def _layout(self, fam: RegionFleetFamily) -> _Layout:
        # built once per family layout and cached process-wide under the
        # evaluator identity, like the reference's structured executables
        key = ("structured", self._eval_key, fam.region.tobytes(),
               fam.n_regions, float(fam.self_cost))

        def build():
            region_ix = torch.as_tensor(fam.region, device=self.device)
            return _Layout(region_ix, region_onehot(region_ix, fam.n_regions),
                           float(fam.self_cost))

        return executable_cache().get_or_build(key, build)

    def _family_args(self, fam: RegionFleetFamily):
        # float32 BEFORE the factors, as the reference's _family_args does
        return self._tensor(fam.inter), self._tensor(fam.degrade)

    def _links(self, x: torch.Tensor):
        """α·enabledLinks (B, E), or None when alpha is off."""
        if not self.cfg.alpha:
            return None
        return links_term(x, self._src, self._dst, self.cfg.alpha,
                          self.cfg.nz_eps)

    def _elat_structured(self, x_i, x_j, lay: _Layout, inter, degrade):
        return structured_edge_latency(x_i, x_j, inter, degrade,
                                       lay.region_ix, lay.onehot,
                                       lay.self_cost)

    def _edge_latencies(self, x: torch.Tensor, com) -> torch.Tensor:
        if isinstance(com, RegionFleetFamily):
            lay = self._layout(com)
            x_i, x_j = edge_endpoints(x, self._src, self._dst, self._sel)
            out = self._elat_structured(x_i, x_j, lay,
                                        *self._family_args(com))
            links = self._links(x)
            return out if links is None else out + links
        return self._elat_dense(x, self._tensor(com))

    # -- public API ----------------------------------------------------------
    def edge_latencies(self, x, com) -> torch.Tensor:
        """(B, E) edge latencies — batched edge_latencies()."""
        return self._edge_latencies(self._tensor(x), com)

    def latency(self, x, com) -> torch.Tensor:
        """(B,) critical-path latencies — batched latency()."""
        return critical_path_dp(self.graph, self.edge_latencies(x, com))

    def objective(self, x, com, dq=0.0, beta: float = 0.0) -> torch.Tensor:
        """(B,) paper eq. (8) objectives — batched objective_F(); ``dq`` a
        scalar or (B,)."""
        lat = self.latency(x, com)
        denom = dq_denominator(dq, beta, lat.shape[0])
        return lat / self._tensor(denom)

    @staticmethod
    def _validate_dq(dq, S: int) -> np.ndarray:
        """dq must be a scalar or EXACTLY (S,) — a wrong-length vector that
        happens to broadcast would silently mis-scale the grid."""
        arr = np.asarray(dq, dtype=np.float64)
        if arr.ndim != 0 and arr.shape != (S,):
            raise ValueError(
                f"dq must be a scalar or shape ({S},) — one entry per "
                f"scenario; got shape {arr.shape} for S={S}")
        return arr.astype(np.float32)

    def _dense_speeds(self, S: int, V: int, speed) -> torch.Tensor:
        """The dense path's optional speed operand as (S, V): None ⇒ unit
        speeds (the paper-faithful 'communication dominates' default), (V,)
        shared, or (S, V) per scenario (:func:`pack_speeds`)."""
        if speed is None:
            return torch.ones((S, V), dtype=torch.float32,
                              device=self.device)
        t = self._tensor(speed)
        if tuple(t.shape) == (V,):
            return t.expand(S, V)
        if tuple(t.shape) != (S, V):
            raise ValueError(f"speed must be (V,) or (S, V) = ({S}, {V}); "
                             f"got shape {tuple(t.shape)}")
        return t

    def score_grid(self, placements, coms, dq=0.0, beta: float = 0.0,
                   objectives=None, speed=None):
        """Score every (scenario, placement) pair on the evaluator's device.
        ``coms`` is a dense (S, V, V) pack or a RegionFleetFamily; ``dq`` a
        scalar or exactly (S,).

        ``objectives=None`` returns the (S, P) float32 latency-F grid.  With
        an :class:`ObjectiveSet` (or anything ``as_objective_set`` accepts)
        it returns an :class:`ObjectiveGrids`: every objective's (S, P) grid
        in the set's order and the weighted scalarization.  ``speed`` feeds
        the occupancy objectives on the dense path ((V,) or (S, V), see
        :func:`pack_speeds`; default unit speeds); structured families
        carry their own speeds, so ``speed`` must stay None there."""
        structured = isinstance(coms, RegionFleetFamily)
        if objectives is None and speed is not None:
            raise ValueError("speed only feeds the occupancy objectives "
                             "— pass objectives= to use it")
        if structured and speed is not None:
            raise ValueError("structured families carry their own "
                             "speeds; leave speed=None")
        if not structured:
            coms = self._tensor(coms)
        S = coms.n_scenarios if structured else coms.shape[0]
        dq_arr = self._validate_dq(dq, S)
        san = sanitize.state()
        if san.enabled and san.domain_check:
            sanitize.check_dq(dq)
        x = self._tensor(placements)
        path = "structured" if structured else "dense"
        reg = obs.registry()
        if reg.enabled:
            reg.counter("eval.score_grid.dispatches", path=path).add(1)
            reg.histogram("eval.score_grid.cells", lo=1.0).observe(
                S * int(x.shape[0]))
        multi = objectives is not None
        with obs.span("score_grid", S=S, P=int(x.shape[0]), path=path,
                      multi=multi) as sp:
            if multi:
                out = self._grid_multi(x, coms, structured,
                                       as_objective_set(objectives), speed,
                                       dq_arr, beta)
                sp.sync(out.scalarized)
            else:
                lat = self._grid_latency(x, coms, structured)
                out = lat / self._tensor(
                    dq_denominator(dq_arr, beta, S))[:, None]
                sp.sync(out)
        if san.enabled and san.nan_check:
            sanitize.check_finite(
                "score_grid", out.scalarized if multi else out)
        return out

    def _grid_latency(self, x: torch.Tensor, coms, structured: bool):
        """(S, P) raw latencies: endpoints once, one kernel launch per
        scenario against that scenario alone, one DP over (S, P, E)."""
        x_i, x_j = edge_endpoints(x, self._src, self._dst, self._sel)
        if structured:
            lay = self._layout(coms)
            inter, degrade = self._family_args(coms)
            elat = [self._elat_structured(x_i, x_j, lay, inter[s:s + 1],
                                          degrade[s:s + 1])
                    for s in range(coms.n_scenarios)]
        else:
            elat = [dispatch.edge_latency(x_i, x_j, coms[s:s + 1])
                    for s in range(coms.shape[0])]
        elat = torch.stack(elat)                             # (S, P, E)
        links = self._links(x)
        if links is not None:
            elat = elat + links
        return critical_path_dp(self.graph, elat)

    # -- multi-objective grids (ObjectiveSet, §3.1) --------------------------
    #
    # latency_f is carved out by name, as in the reference: it rides the
    # evaluator's own edge machinery (K1/K2 on the card, one launch per
    # scenario, one DP) instead of the spec's builders — a test pins both
    # routes to the same oracle.  Every other objective runs its batched
    # twin once per scenario over all P placements.

    def _multi_builders(self, obj_set: ObjectiveSet, coms, structured: bool):
        """{name: f} for the set's objectives other than latency_f, built
        once per (evaluator, set[, family layout]) and cached."""
        others = [s for s in obj_set.specs if s.name != "latency_f"]
        if structured:
            key = ("multi_structured", self._eval_key, coms.region.tobytes(),
                   coms.n_regions, float(coms.self_cost), obj_set)

            def build():
                return {s.name: s.build_structured(
                    self.graph, coms.region, coms.n_regions, coms.self_cost,
                    self.cfg, self.device) for s in others}
        else:
            key = ("multi_dense", self._eval_key, obj_set)

            def build():
                return {s.name: s.build_dense(self.graph, self.cfg,
                                              self.device) for s in others}

        return executable_cache().get_or_build(key, build)

    def _grid_multi(self, x: torch.Tensor, coms, structured: bool,
                    obj_set: ObjectiveSet, speed, dq_arr, beta: float
                    ) -> ObjectiveGrids:
        builders = self._multi_builders(obj_set, coms, structured)
        raw = {}
        if "latency_f" in obj_set.names:
            raw["latency_f"] = self._grid_latency(x, coms, structured)
        if structured:
            inter, degrade = self._family_args(coms)
            # nominal speeds: the structured occupancy twin applies the
            # scenario's degrade itself (effective = speed / degrade)
            speeds = self._tensor(np.array(coms.speed_or_ones()))
            for name, f in builders.items():
                raw[name] = torch.stack([
                    f(x, inter[s], degrade[s], speeds[s])
                    for s in range(coms.n_scenarios)])
        else:
            S, V = coms.shape[0], coms.shape[1]
            speeds = self._dense_speeds(S, V, speed)
            for name, f in builders.items():
                raw[name] = torch.stack([f(x, coms[s], speeds[s])
                                         for s in range(S)])
        return self._finish_multi(obj_set, raw, dq_arr, beta)

    def _finish_multi(self, obj_set: ObjectiveSet, raw: dict, dq_arr,
                      beta: float) -> ObjectiveGrids:
        """spec.finish on every (S, P) grid (dq as an (S, 1) column), then
        the weighted sum; grids in the set's declared order."""
        S = next(iter(raw.values())).shape[0]
        dq_col = self._tensor(np.full((S,), dq_arr) if np.ndim(dq_arr) == 0
                              else dq_arr)[:, None]
        grids = {s.name: s.finish(raw[s.name], dq_col, beta)
                 for s in obj_set.specs}
        stacked = torch.stack([grids[n] for n in obj_set.names])  # (K, S, P)
        weights = self._tensor(np.asarray(obj_set.weights, np.float32))
        scal = torch.einsum("k,ksp->sp", weights, stacked)
        return ObjectiveGrids(names=obj_set.names, grids=grids,
                              scalarized=scal, weights=obj_set.weights)
