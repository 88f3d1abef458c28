"""Closing the calibrate → optimize loop from OBSERVED replay behavior —
the replay part of ``repro.core.calibration``, copied for the PyTorch port.

:func:`refit_from_replay` takes a window of replay observations (per-tick
rates, per-device busy seconds, an end-to-end latency signal) and re-fits
the *believed* fleet — per-device slowdown multipliers from the busy series
(the §3.1 occupancy model run backwards) and a global com-cost scale from
the latency ratio — so a controller (:mod:`repro_torch.adapt`) can
re-optimize placement against a model that tracks the drifted world again.

Everything here is float64 numpy and bitwise equal to the reference.

The static half turns a counted step into cost-model inputs:
:func:`calibrate_from_profile` (the counterpart of the reference's
``calibrate_from_hlo``) reads the collective traffic of a
``repro_torch.perf.counts.ModuleStats`` — a step counted as it ran, in
place of TPU HLO text — and prices it on an H100 cluster
(:func:`repro_torch.core.devices.fleet_from_gpu_mesh`: NVLink within a
node, the network between nodes); :func:`stage_graph_for_lm` is the
reference's train-step dataflow graph, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costmodel import CostConfig, latency
from repro_torch.core.devices import (NVLINK_GBPS, ExplicitFleet,
                                      RegionFleet, fleet_from_gpu_mesh)
from repro_torch.core.graph import Operator, OpGraph
from repro_torch.perf.counts import CollectiveStats, ModuleStats

__all__ = ["CalibratedCosts", "calibrate_from_profile", "stage_graph_for_lm",
           "ReplayWindow", "ReplayRefit", "fit_work_unit",
           "normalized_drift", "refit_from_replay"]


@dataclasses.dataclass
class CalibratedCosts:
    """comCost units: seconds per byte; work units: flop."""

    fleet: RegionFleet
    collectives: CollectiveStats
    bytes_per_step: float  # per-device collective wire bytes
    flops_per_step: float  # per-device FLOPs

    def step_comm_seconds(self, link_gbps: float = NVLINK_GBPS) -> float:
        return self.bytes_per_step / (link_gbps * 1e9)


def calibrate_from_profile(stats: ModuleStats, flops_per_device: float,
                           n_nodes: int = 1,
                           gpus_per_node: int = 8) -> CalibratedCosts:
    """Cost-model inputs from one counted step (``perf.counts``): its
    per-device collective wire bytes on an H100 fleet of ``n_nodes`` ×
    ``gpus_per_node`` priced per byte."""
    fleet = fleet_from_gpu_mesh(n_nodes=n_nodes, gpus_per_node=gpus_per_node,
                                unit_bytes=1.0)
    return CalibratedCosts(
        fleet=fleet,
        collectives=stats.collectives,
        bytes_per_step=stats.collectives.total_wire_bytes,
        flops_per_step=flops_per_device,
    )


def stage_graph_for_lm(n_layers: int, d_model: int, d_ff: int, vocab: int,
                       seq: int, batch: int, moe_experts: int = 0,
                       top_k: int = 2) -> OpGraph:
    """The train-step dataflow as a paper OpGraph.

    Operators are stages (embed → L×block → head → loss → backward echo);
    selectivity is the bytes-amplification between stages — this is the graph
    auto-sharding scores candidate placements against.  Tuple unit = one
    token's activation row (d_model × 2 bytes bf16).
    """
    tok_bytes = 2.0 * d_model
    ops = [Operator("source", selectivity=1.0, out_bytes=4.0)]  # token ids
    ops.append(Operator("embed", selectivity=1.0, out_bytes=tok_bytes))
    edges = [(0, 1)]
    prev = 1
    for l in range(n_layers):
        amp = 1.0
        if moe_experts:
            # top-k dispatch duplicates tokens k× on the expert axis
            amp = float(top_k)
        ops.append(Operator(f"block{l}", selectivity=amp, out_bytes=tok_bytes,
                            work=1.0))
        edges.append((prev, len(ops) - 1))
        prev = len(ops) - 1
    ops.append(Operator("head", selectivity=vocab / d_model,
                        out_bytes=2.0 * vocab, work=1.0))
    edges.append((prev, len(ops) - 1))
    ops.append(Operator("loss", selectivity=1.0 / vocab, out_bytes=4.0))
    edges.append((len(ops) - 2, len(ops) - 1))
    return OpGraph(ops, edges)


# -- closed-loop recalibration from replay observations -----------------------

@dataclasses.dataclass
class ReplayWindow:
    """A window of per-tick replay observations, the input of
    :func:`refit_from_replay`.

    Attributes:
      rates: (T,) source rows per tick.
      busy: (T, V) observed per-device busy seconds.
      observed_latency: (T,) end-to-end latency signal per tick (any unit —
        the fit absorbs the unit into ``com_scale``).
      xs: the placement(s) active during the window — (n_ops, V) shared, or
        (T, n_ops, V) per tick.
      op_rows_in / op_rows_out: optional (T, n_ops) per-operator row
        counters (``BatchReport.op_rows_in/out``).  With inputs the busy
        fit predicts load from the rows each operator ACTUALLY processed
        (immune to selectivity drift); with both, the per-operator true
        selectivity is re-fit too.
    """

    rates: np.ndarray
    busy: np.ndarray
    observed_latency: np.ndarray
    xs: np.ndarray
    op_rows_in: np.ndarray | None = None
    op_rows_out: np.ndarray | None = None

    def __post_init__(self):
        self.rates = np.asarray(self.rates, dtype=np.float64)
        self.busy = np.asarray(self.busy, dtype=np.float64)
        self.observed_latency = np.asarray(self.observed_latency,
                                           dtype=np.float64)
        self.xs = np.asarray(self.xs, dtype=np.float64)
        t, v = self.busy.shape
        if self.rates.shape != (t,) or self.observed_latency.shape != (t,):
            raise ValueError(
                f"window shapes disagree: busy {self.busy.shape}, rates "
                f"{self.rates.shape}, observed {self.observed_latency.shape}")
        if self.xs.ndim == 2:
            self.xs = np.broadcast_to(self.xs, (t,) + self.xs.shape)
        if self.xs.shape[0] != t or self.xs.shape[2] != v:
            raise ValueError(f"xs has shape {self.xs.shape}, want "
                             f"({t}, n_ops, {v})")
        n_ops = self.xs.shape[1]
        for name in ("op_rows_in", "op_rows_out"):
            arr = getattr(self, name)
            if arr is not None:
                arr = np.asarray(arr, dtype=np.float64)
                if arr.shape != (t, n_ops):
                    raise ValueError(f"{name} has shape {arr.shape}, want "
                                     f"({t}, {n_ops})")
                setattr(self, name, arr)

    @property
    def n_ticks(self) -> int:
        return self.busy.shape[0]

    @classmethod
    def from_report(cls, report, x: np.ndarray) -> "ReplayWindow":
        """Build a window from a :class:`repro_torch.sim.replay.ReplayReport`
        (its trailing constant-device-count suffix) with the per-tick max
        busy as the latency signal — the observation plain replay has."""
        busy = report.busy_series()
        steps = [s for s in report.steps if s.device_busy is not None]
        tail = steps[len(steps) - busy.shape[0]:]
        return cls(rates=np.array([s.rate for s in tail]),
                   busy=busy,
                   observed_latency=busy.max(axis=1, initial=0.0)
                   if busy.size else np.zeros(busy.shape[0]),
                   xs=np.asarray(x, dtype=np.float64))


def normalized_drift(observed: np.ndarray, modeled: np.ndarray) -> float:
    """RMS of (observed/modeled − 1) over ticks where both are positive —
    0 ⇒ the (unit-calibrated) model matches observation exactly; NaN when
    fewer than 2 ticks carry signal.  This is the trigger signal of the
    adaptive controller: unlike ``ReplayReport.drift``'s scale-free
    ``ratio_rel_std`` it DOES charge a constant offset, because the
    controller maintains its own unit calibration and a persistent offset
    means the calibration is stale."""
    o = np.asarray(observed, dtype=np.float64)
    m = np.asarray(modeled, dtype=np.float64)
    keep = (o > 0) & (m > 0)
    if keep.sum() < 2:
        return float("nan")
    r = o[keep] / m[keep]
    return float(np.sqrt(np.mean((r - 1.0) ** 2)))


@dataclasses.dataclass
class ReplayRefit:
    """Result of :func:`refit_from_replay`.

    ``fleet`` is the recalibrated belief: the input fleet's com costs scaled
    by ``outer(degrade, degrade)`` off-diagonal (structure) times
    ``com_scale`` (units/global drift), with ``speed`` as the new effective
    speeds.  ``graph`` is the belief's operator graph with the re-fit
    selectivities (the input graph unchanged when the window carries no row
    counters).  ``pre_drift``/``post_drift`` are :func:`normalized_drift`
    of the window against the old and new belief — the fit is only adopted
    when it actually explains the window better."""

    com_scale: float
    degrade: np.ndarray  # (V,) per-device slowdown multipliers (1 = healthy)
    speed: np.ndarray    # (V,) re-fitted effective speeds
    sel_scale: np.ndarray  # (n_ops,) selectivity drift estimates (1 = none)
    fleet: ExplicitFleet
    graph: OpGraph
    work_unit: float     # busy-seconds per (work·row) anchoring the fit
    n_ticks: int
    pre_drift: float
    post_drift: float
    # observation evidence behind the estimates: which devices carried busy
    # signal and how much predicted work mass each one processed over the
    # window — the weights a belief layer (repro_torch.belief) uses for its
    # count-weighted posterior updates
    signal: np.ndarray | None = None
    obs_weight: np.ndarray | None = None
    op_obs_weight: np.ndarray | None = None  # (n_ops,) input rows per op
    # posterior slowdown variance AFTER this refit was written into a
    # belief (refit_from_replay(..., belief=...)); None without a belief
    posterior_var: np.ndarray | None = None


def _busy_ratio(graph: OpGraph, fleet, window: ReplayWindow
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-device ``work_unit · slowdown_u`` estimates from the busy series,
    which devices carry signal, and how much evidence each estimate rests on.

    The occupancy model predicts ``busy[t, u] = work_unit · Σ_i
    work_i·rows_i(t)·x_{t,i,u} / speed_u``; with the window's observed
    per-op input rows the prediction is exact under selectivity drift,
    otherwise rows are approximated by ``rate_t · cumulative_rate_i``.

    The returned ``weight`` is the total predicted work mass routed to each
    device over the window — the natural observation count: a device that
    processed 10⁴ work·rows pins its ratio, one that saw a stray 10⁻⁶ of
    mass produces a ratio dominated by quantization noise."""
    if window.op_rows_in is not None:
        wk = np.array([op.work for op in graph.operators])
        rows = window.op_rows_in * wk[None, :]               # (T, n_ops)
    else:
        rates = graph.cumulative_rates()
        wk = np.array([op.work * rates[i]
                       for i, op in enumerate(graph.operators)])
        rows = window.rates[:, None] * wk[None, :]           # (T, n_ops)
    load = np.einsum("ti,tiu->tu", rows, window.xs)
    pred_u = load.sum(axis=0)                                # (V,)
    obs_u = window.busy.sum(axis=0)                          # (V,)
    signal = (pred_u > 1e-12) & (obs_u > 0.0)
    believed_speed = np.asarray(fleet.effective_speed(), dtype=np.float64)
    ratio = np.zeros(window.busy.shape[1])
    # obs/pred = work_unit·slowdown_u/believed_speed_u ⇒ multiply by the
    # believed speed to isolate work_unit·slowdown_u
    ratio[signal] = obs_u[signal] / pred_u[signal] * believed_speed[signal]
    weight = np.where(signal, pred_u, 0.0)
    return ratio, signal, weight


def _weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    """Median of ``values`` under ``weights`` (lower weighted median): the
    smallest value whose cumulative weight reaches half the total.  Reduces
    to an element of ``values`` (never an interpolation), so one noisy
    near-zero-weight estimate cannot drag the pooled value off the
    well-observed ones."""
    order = np.argsort(values, kind="stable")
    v = values[order]
    w = weights[order]
    total = float(w.sum())
    if total <= 0.0:
        return float(np.median(v))
    k = int(np.searchsorted(np.cumsum(w), 0.5 * total))
    return float(v[min(k, v.size - 1)])


def fit_work_unit(graph: OpGraph, fleet, window: ReplayWindow) -> float:
    """Calibrate the busy-seconds-per-(work·row) unit from a window where
    the fleet belief is trusted (typically the run's first ticks): the
    median per-device ratio.  Anchoring later refits to this constant lets
    them read a UNIFORM busy inflation as real fleet-wide slowdown instead
    of silently renormalizing it away (a whole-region outage where every
    mass-carrying device sits in the region looks uniform).  NaN when no
    device carries signal."""
    ratio, signal, _ = _busy_ratio(graph, fleet, window)
    if not signal.any():
        return float("nan")
    return float(np.median(ratio[signal]))


def _refit_selectivities(graph: OpGraph,
                         window: ReplayWindow) -> tuple[np.ndarray, OpGraph]:
    """(sel_scale, graph') from the window's per-op row counters: operator
    i's observed selectivity is Σ_t out_i / Σ_t in_i (ops with no input
    rows keep their nominal value)."""
    n_ops = graph.n_ops
    scale = np.ones(n_ops)
    if window.op_rows_in is None or window.op_rows_out is None:
        return scale, graph
    tot_in = window.op_rows_in.sum(axis=0)
    tot_out = window.op_rows_out.sum(axis=0)
    for i, op in enumerate(graph.operators):
        if tot_in[i] > 0.0 and op.selectivity > 0.0:
            scale[i] = (tot_out[i] / tot_in[i]) / op.selectivity
    ops = [dataclasses.replace(op,
                               selectivity=float(op.selectivity * scale[i]))
           for i, op in enumerate(graph.operators)]
    return scale, OpGraph(ops, list(graph.edges))


def refit_from_replay(graph: OpGraph, fleet, window: ReplayWindow,
                      cfg: CostConfig = CostConfig(),
                      work_unit: float | None = None,
                      degrade_bounds: tuple[float, float] = (0.05, 1e6),
                      belief=None) -> ReplayRefit:
    """Re-fit the believed fleet (and operator selectivities) from observed
    replay behavior.

    Three estimators, run in sequence so they never double-count:

    1. **selectivities** from the per-op row counters (when the window has
       them): observed out/in rows per operator — the belief graph then
       prices the drifted flow, not the nominal one.
    2. **per-device slowdowns** from the busy series (:func:`_busy_ratio`):
       the per-device ratio of observed to predicted busy, relative to the
       believed effective speed, divided by the work-time unit.  Pass the
       ``work_unit`` calibrated on a trusted window (:func:`fit_work_unit`)
       so uniform fleet-wide slowdowns are read as real; with
       ``work_unit=None`` the window's median device anchors the unit
       (self-calibrating, but blind to uniform shifts).  Devices with no
       mass (no busy signal) keep their believed speed.
    3. **global com scale** from the latency signal, measured against the
       believed model WITH steps 1–2 already applied — the mean
       observed/modeled ratio prices whatever drift the structure cannot
       explain.

    Requires ≥2 ticks (raises ValueError otherwise — the controller guards
    zero/one-tick windows and simply skips the refit).

    ``belief`` (a :class:`repro_torch.belief.BeliefState`) makes the refit WRITE
    its observations into the belief: the per-device slowdown estimates land
    as an observation-count-weighted posterior update (weights = predicted
    work mass per device) and the returned refit carries the belief's
    posterior variance after the write (``posterior_var``).  Adoption of the
    point estimate stays the caller's decision (``belief.commit``).
    """
    if window.n_ticks < 2:
        raise ValueError(f"refit needs ≥2 ticks, got {window.n_ticks}")
    v = window.busy.shape[1]
    if fleet.n_devices != v:
        raise ValueError(f"fleet has {fleet.n_devices} devices, window {v}")
    believed_speed = np.asarray(fleet.effective_speed(), dtype=np.float64)
    sel_scale, graph_fit = _refit_selectivities(graph, window)
    ratio, signal, obs_weight = _busy_ratio(graph_fit, fleet, window)
    anchor = work_unit if work_unit is not None \
        and np.isfinite(work_unit) and work_unit > 0.0 else None
    if anchor is None and signal.any():
        anchor = float(np.median(ratio[signal]))
    degrade = np.ones(v)
    if anchor and anchor > 0.0:
        degrade[signal] = np.clip(ratio[signal] / anchor, *degrade_bounds)
    # region pooling: a device the placement put no mass on emits no busy
    # signal, but fleet failures are region-correlated (outages take whole
    # regions down) — blind devices inherit the pooled estimate of their
    # region-mates that DO carry signal, so the re-optimizer cannot dump
    # mass onto an unobserved device of a struggling region.  The pool is
    # an observation-WEIGHTED median: a region-mate whose "signal" is a
    # stray sliver of mass (near-zero busy samples) contributes a ratio
    # made of quantization noise, and with exactly one well-observed device
    # in the region an unweighted median would average the two — diluting
    # the only real estimate (pinned in tests/test_refit.py).
    region = getattr(fleet, "region", None)
    if region is not None and signal.any() and not signal.all():
        region = np.asarray(region)
        for r in np.unique(region[~signal]):
            sig = (region == r) & signal
            if sig.any():
                degrade[(region == r) & ~signal] = \
                    _weighted_median(degrade[sig], obs_weight[sig])
    speed = believed_speed / degrade
    # structure first: com' = com·d_u·d_v off-diagonal (diag kept)
    com = np.asarray(fleet.com_matrix(), dtype=np.float64)
    com_s = com * np.outer(degrade, degrade)
    np.fill_diagonal(com_s, np.diag(com))
    avail = getattr(fleet, "available", None)
    structured = ExplicitFleet(com_cost=com_s, speed=speed, available=avail,
                               region=getattr(fleet, "region", None))
    modeled0 = np.array([latency(graph, fleet, x, cfg) for x in window.xs])
    modeled1 = np.array([latency(graph_fit, structured, x, cfg)
                         for x in window.xs])
    pre_drift = normalized_drift(window.observed_latency, modeled0)
    keep = (window.observed_latency > 0) & (modeled1 > 0)
    com_scale = float(np.mean(window.observed_latency[keep]
                              / modeled1[keep])) if keep.sum() else 1.0
    if not np.isfinite(com_scale) or com_scale <= 0.0:
        com_scale = 1.0
    # com_scale is a UNIT recalibration, so it scales every entry — the
    # self-cost diagonal included (com_s already carries diag(com))
    refit_fleet = ExplicitFleet(com_cost=com_s * com_scale, speed=speed,
                                available=avail,
                                region=getattr(fleet, "region", None))
    post_drift = normalized_drift(window.observed_latency,
                                  com_scale * modeled1)
    op_obs_weight = None if window.op_rows_in is None \
        else window.op_rows_in.sum(axis=0)
    refit = ReplayRefit(com_scale=com_scale, degrade=degrade, speed=speed,
                        sel_scale=sel_scale, fleet=refit_fleet,
                        graph=graph_fit,
                        work_unit=float(anchor) if anchor else float("nan"),
                        n_ticks=window.n_ticks,
                        pre_drift=pre_drift, post_drift=post_drift,
                        signal=signal, obs_weight=obs_weight,
                        op_obs_weight=op_obs_weight)
    if belief is not None:
        belief.update_from_refit(refit)
        refit = dataclasses.replace(refit,
                                    posterior_var=belief.posterior_var())
    return refit
