"""Scenario generators: parameterized random families of geo-fleets, DAG
topologies, and streaming workload traces.

COSTREAM-style cost models earn their keep when evaluated over large
families of *unseen* operator/hardware combinations, not one hand-built
instance.  This module is the family factory:

  * fleets  — region counts, heterogeneous device speeds, and com-cost
    distributions drawn from lognormals (WAN links are heavy-tailed);
  * graphs  — chains, diamonds, fan-in/fan-out, layered random DAGs
    (the paper's Table 2 topologies, randomized);
  * traces  — diurnal rate curves with burst injections plus timed device
    degradations/losses, replayable through the StreamingEngine
    (repro_torch.sim.replay).

``scenario_batch`` fixes one job graph and device count so the resulting
(placement × fleet) tensors stack — the contract the batched evaluator
(repro_torch.sim.batched) scores in one dispatch.

numpy-only copy of ``repro.sim.scenarios`` for the PyTorch port: every
generator consumes the rng stream exactly as the reference does, so one
seed gives both packages the same fleets, graphs and traces.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.devices import (ExplicitFleet, RegionFleet,
                                      RegionFleetFamily)
from repro_torch.core.graph import Operator, OpGraph, random_dag

__all__ = [
    "MIN_ALIVE_DEVICES",
    "ScenarioConfig",
    "TraceEvent",
    "Scenario",
    "random_fleet",
    "perturbed_fleet",
    "region_fleet_family",
    "random_graph",
    "diurnal_rate",
    "random_trace",
    "random_scenario",
    "scenario_batch",
    "region_scenario_batch",
]

GRAPH_FAMILIES = ("chain", "diamond", "fan_out", "fan_in", "layered")

# The device-removal floor shared by trace GENERATION (random_trace) and
# trace REPLAY (repro_torch.sim.replay.replay_trace): a removal is only allowed
# while more than this many devices are alive, so the fleet never drops
# below MIN_ALIVE_DEVICES — the engine always has somewhere to re-place
# AND a second device to move load to.
MIN_ALIVE_DEVICES = 2


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Knobs of the random scenario family (all distributions, no fixtures).

    Fleet: ``n_regions`` regions of ``devices_per_region`` devices; link
    costs are lognormal(``com_logmean``, ``com_logstd``) between regions and
    ``intra_discount``× that within one; device speeds are lognormal around
    1.  Trace: ``trace_len`` ticks of a diurnal curve with amplitude
    ``diurnal_amplitude`` around ``base_rate`` rows/tick, plus bursts
    (``burst_prob`` per tick, ×``burst_factor``) and fleet events
    (``degrade_prob``/``loss_prob`` per tick).
    """

    n_regions: tuple[int, int] = (2, 5)
    devices_per_region: tuple[int, int] = (2, 6)
    com_logmean: float = 0.0
    com_logstd: float = 0.6
    intra_discount: float = 0.1
    speed_logstd: float = 0.3
    graph_families: tuple[str, ...] = GRAPH_FAMILIES
    n_ops: tuple[int, int] = (4, 10)
    max_selectivity: float = 2.0
    # per-operator payloads so the §3.1 objectives are non-degenerate on
    # generated graphs: out_bytes drives network movement, op_work drives
    # device occupancy (zero work ⇒ occupancy identically zero)
    out_bytes: tuple[float, float] = (0.25, 4.0)
    op_work: tuple[float, float] = (0.05, 0.5)
    trace_len: int = 48
    base_rate: float = 256.0
    diurnal_amplitude: float = 0.6
    diurnal_period: int = 24
    burst_prob: float = 0.08
    burst_factor: float = 4.0
    degrade_prob: float = 0.04
    degrade_factor: tuple[float, float] = (2.0, 8.0)
    loss_prob: float = 0.02
    # Markov time-correlated whole-region outages WITHIN one trace: a healthy
    # region enters outage with prob outage_on_prob per tick and stays out
    # for a geometric duration (leaves with prob outage_off_prob per tick) —
    # correlated failures over time, not independent per-tick coin flips.
    # 0.0 (default) disables them AND leaves the rng stream of pre-existing
    # traces untouched (seed-for-seed backward compatible).
    outage_on_prob: float = 0.0
    outage_off_prob: float = 0.25
    trace_outage_factor: float = 32.0
    # selectivity drift: each tick one random operator's TRUE selectivity
    # takes a lognormal(0, selectivity_drift_std) random-walk step (clamped
    # so the cumulative scale stays within selectivity_drift_bounds); the
    # cost-model metadata goes stale until a controller recalibrates.
    # 0.0 (default) disables it, preserving the pre-existing rng stream.
    selectivity_drift_std: float = 0.0
    selectivity_drift_bounds: tuple[float, float] = (0.25, 4.0)
    explicit_fleet: bool = True  # materialize ExplicitFleet (else RegionFleet)
    # structured (RegionFleetFamily) what-if knobs: per-scenario region-level
    # link jitter, independent device stragglers, and whole-region outages
    region_jitter: float = 0.3
    straggler_prob: float = 0.05
    outage_prob: float = 0.04
    outage_factor: float = 1e4


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One tick of a workload trace.

    kind: "rate" (plain tick), "burst" (rate spike), "degrade" (device's
    links/compute get ``factor``× slower), "remove" (device loss),
    "outage" / "recover" (whole-REGION failure entering/lifting — ``device``
    holds the region id and ``factor`` the degrade multiplier), "drift"
    (operator ``device``'s TRUE selectivity scales by ``factor``; the cost
    model's metadata is left stale).
    """

    t: int
    kind: str
    rate: float
    device: int = -1  # device id; region id for outage/recover; op for drift
    factor: float = 1.0


@dataclasses.dataclass
class Scenario:
    """One generated what-if world: a job graph on a fleet under a trace."""

    name: str
    graph: OpGraph
    fleet: ExplicitFleet | RegionFleet
    trace: list[TraceEvent]
    beta: float = 0.0
    dq_fraction: float = 0.0

    @property
    def n_devices(self) -> int:
        return self.fleet.n_devices


# -- fleets -------------------------------------------------------------------

def random_fleet(rng: np.random.Generator, cfg: ScenarioConfig = ScenarioConfig(),
                 n_devices: int | None = None):
    """Random geo-fleet.  ``n_devices`` pins the device count (so fleets of
    one scenario batch stack); regions then get a random partition of it."""
    n_regions = int(rng.integers(cfg.n_regions[0], cfg.n_regions[1] + 1))
    if n_devices is None:
        per = rng.integers(cfg.devices_per_region[0],
                           cfg.devices_per_region[1] + 1, n_regions)
    else:
        n_regions = min(n_regions, n_devices)
        per = np.ones(n_regions, dtype=np.int64)
        extra = rng.multinomial(n_devices - n_regions,
                                np.ones(n_regions) / n_regions)
        per = per + extra
    region = np.repeat(np.arange(n_regions), per)
    inter = rng.lognormal(cfg.com_logmean, cfg.com_logstd,
                          (n_regions, n_regions))
    inter = (inter + inter.T) / 2.0
    np.fill_diagonal(inter, np.diag(inter) * cfg.intra_discount)
    speed = rng.lognormal(0.0, cfg.speed_logstd, region.size)
    rf = RegionFleet(region=region, inter=inter, self_cost=0.0, speed=speed)
    if not cfg.explicit_fleet:
        return rf
    return ExplicitFleet(com_cost=rf.com_matrix(), speed=speed, region=region)


def perturbed_fleet(fleet, rng: np.random.Generator, jitter: float = 0.3):
    """A nearby what-if fleet: every link cost multiplied by an independent
    lognormal(1, jitter) factor (symmetric).  Used to turn one measured
    fleet into a robustness family."""
    com = np.asarray(fleet.com_matrix(), dtype=np.float64)
    noise = rng.lognormal(0.0, jitter, com.shape)
    noise = (noise + noise.T) / 2.0
    com2 = com * noise
    np.fill_diagonal(com2, np.diag(com))
    # effective speed: the com matrix above carries any degrade multipliers,
    # so the materialized fleet must carry the matching compute slowdown too
    return ExplicitFleet(com_cost=com2, speed=fleet.effective_speed().copy(),
                         region=getattr(fleet, "region", None))


def region_fleet_family(rng: np.random.Generator, n_scenarios: int,
                        cfg: ScenarioConfig = ScenarioConfig(),
                        n_devices: int | None = None,
                        base: RegionFleet | None = None) -> RegionFleetFamily:
    """A structured what-if family around one base RegionFleet.

    Each scenario perturbs *region-level* state only, so the family packs as
    a :class:`RegionFleetFamily` — O(S·(R² + V)) memory, never an (S, V, V)
    tensor, which is what lets ``score_grid`` reach 10⁵-device fleets:

      * link jitter — every inter-region cost multiplied by a symmetric
        lognormal(1, ``region_jitter``) factor (WAN weather);
      * stragglers — each device independently degraded with probability
        ``straggler_prob`` by a ``degrade_factor``-range multiplier;
      * whole-region outages — with probability ``outage_prob`` per region,
        every link touching that region's devices gets ``outage_factor``×
        slower (a soft outage: the optimizer routes around it).  At least
        one region is always kept healthy.
    """
    if base is None:
        base = random_fleet(rng, dataclasses.replace(cfg, explicit_fleet=False),
                            n_devices=n_devices)
    if not isinstance(base, RegionFleet):
        raise ValueError("region_fleet_family needs a RegionFleet base")
    v, r = base.n_devices, base.n_regions
    base_d = base.degrade_or_ones()
    inters = np.empty((n_scenarios, r, r))
    degrades = np.ones((n_scenarios, v))
    for s in range(n_scenarios):
        noise = rng.lognormal(0.0, cfg.region_jitter, (r, r))
        inters[s] = base.inter * (noise + noise.T) / 2.0
        d = base_d.copy()
        straggler = rng.random(v) < cfg.straggler_prob
        d[straggler] *= rng.uniform(*cfg.degrade_factor, int(straggler.sum()))
        outage = rng.random(r) < cfg.outage_prob
        if outage.all():
            outage[int(rng.integers(r))] = False
        d[outage[base.region]] *= cfg.outage_factor
        degrades[s] = d
    return RegionFleetFamily(
        region=base.region.copy(), inter=inters, degrade=degrades,
        self_cost=base.self_cost,
        speed=None if base.speed is None else base.speed.copy())


# -- graphs -------------------------------------------------------------------

def _sel(rng: np.random.Generator, cfg: ScenarioConfig) -> float:
    return float(rng.uniform(0.1, cfg.max_selectivity))


def _with_payload(g: OpGraph, rng: np.random.Generator,
                  cfg: ScenarioConfig) -> OpGraph:
    """Draw per-operator out_bytes / work so every §3.1 objective has
    something to price on a generated graph (uniform over the configured
    ranges; applied to all topology families alike)."""
    ops = [dataclasses.replace(
        op,
        out_bytes=float(rng.uniform(*cfg.out_bytes)),
        work=float(rng.uniform(*cfg.op_work)))
        for op in g.operators]
    return OpGraph(ops, list(g.edges))


def random_graph(rng: np.random.Generator,
                 cfg: ScenarioConfig = ScenarioConfig(),
                 family: str | None = None) -> OpGraph:
    """One topology drawn from the configured families, with per-operator
    out_bytes/work payloads (network movement and occupancy objectives are
    non-degenerate on every generated graph)."""
    family = family or cfg.graph_families[
        int(rng.integers(len(cfg.graph_families)))]
    n = int(rng.integers(cfg.n_ops[0], cfg.n_ops[1] + 1))
    if family == "chain":
        ops = [Operator(f"op{i}", _sel(rng, cfg)) for i in range(n)]
        g = OpGraph(ops, [(i, i + 1) for i in range(n - 1)])
    elif family == "diamond":
        width = max(n - 2, 2)
        ops = ([Operator("src", 1.0)]
               + [Operator(f"mid{k}", _sel(rng, cfg)) for k in range(width)]
               + [Operator("sink", 1.0)])
        edges = [(0, 1 + k) for k in range(width)] \
            + [(1 + k, 1 + width) for k in range(width)]
        g = OpGraph(ops, edges)
    elif family == "fan_out":
        ops = [Operator("src", 1.0)] \
            + [Operator(f"leaf{k}", _sel(rng, cfg)) for k in range(n - 1)]
        g = OpGraph(ops, [(0, k) for k in range(1, n)])
    elif family == "fan_in":
        ops = [Operator(f"feed{k}", _sel(rng, cfg)) for k in range(n - 1)] \
            + [Operator("agg", 1.0)]
        g = OpGraph(ops, [(k, n - 1) for k in range(n - 1)])
    elif family == "layered":
        g = random_dag(n, edge_prob=0.45, rng=rng,
                       max_selectivity=cfg.max_selectivity)
    else:
        raise ValueError(f"unknown graph family {family!r}; "
                         f"choose from {GRAPH_FAMILIES}")
    return _with_payload(g, rng, cfg)


# -- traces -------------------------------------------------------------------

def diurnal_rate(t: int, cfg: ScenarioConfig = ScenarioConfig(),
                 phase: float = 0.0) -> float:
    """Rows per tick on the daily sine: base·(1 + A·sin(2πt/period + φ))."""
    return cfg.base_rate * (
        1.0 + cfg.diurnal_amplitude
        * math.sin(2.0 * math.pi * t / cfg.diurnal_period + phase))


def random_trace(rng: np.random.Generator, n_devices: int,
                 cfg: ScenarioConfig = ScenarioConfig(),
                 n_regions: int | None = None,
                 n_ops: int | None = None) -> list[TraceEvent]:
    """A timed event sequence; at most one classic fleet event per tick.

    Removal floor: a ``remove`` is only emitted while MORE than
    :data:`MIN_ALIVE_DEVICES` devices are alive, so the fleet never drops
    below ``MIN_ALIVE_DEVICES`` (= 2) — the same invariant
    :func:`repro_torch.sim.replay.replay_trace` enforces at replay time (a
    regression test pins the 3-device boundary).

    Two correlated-over-time realism layers, both off by default (their
    config knobs are 0.0, and disabled layers draw NOTHING from the rng, so
    pre-existing seeds reproduce byte-identical traces):

      * Markov whole-region outages (``cfg.outage_on_prob`` > 0, needs
        ``n_regions``): each healthy region enters outage with
        ``outage_on_prob`` per tick, emits ``outage`` (region id in
        ``device``, ``trace_outage_factor`` in ``factor``), and leaves with
        ``outage_off_prob`` per tick via a matching ``recover`` — geometric
        outage durations, i.e. failures correlated over TIME.  At least one
        region always stays healthy, and every open outage is closed by a
        final recover so the trace ends on a healthy fleet.
      * selectivity drift (``cfg.selectivity_drift_std`` > 0, needs
        ``n_ops``): each tick one random operator takes a lognormal
        random-walk step, clamped so the cumulative drift stays within
        ``cfg.selectivity_drift_bounds``.
    """
    phase = float(rng.uniform(0.0, 2.0 * math.pi))
    alive = list(range(n_devices))
    events: list[TraceEvent] = []
    out_regions: set[int] = set()
    sel_cum = None if n_ops is None else np.ones(n_ops)
    markov = cfg.outage_on_prob > 0.0 and n_regions is not None \
        and n_regions > 1
    drifting = cfg.selectivity_drift_std > 0.0 and n_ops
    for t in range(cfg.trace_len):
        rate = diurnal_rate(t, cfg, phase)
        kind = "rate"
        if rng.random() < cfg.burst_prob:
            kind, rate = "burst", rate * cfg.burst_factor
        events.append(TraceEvent(t=t, kind=kind, rate=rate))
        roll = rng.random()
        if roll < cfg.loss_prob and len(alive) > MIN_ALIVE_DEVICES:
            dead = alive.pop(int(rng.integers(len(alive))))
            events.append(TraceEvent(t=t, kind="remove", rate=0.0,
                                     device=dead))
        elif roll < cfg.loss_prob + cfg.degrade_prob and alive:
            events.append(TraceEvent(
                t=t, kind="degrade", rate=0.0,
                device=alive[int(rng.integers(len(alive)))],
                factor=float(rng.uniform(*cfg.degrade_factor))))
        if markov:
            for r in sorted(out_regions):
                if rng.random() < cfg.outage_off_prob:
                    out_regions.discard(r)
                    events.append(TraceEvent(
                        t=t, kind="recover", rate=0.0, device=r,
                        factor=cfg.trace_outage_factor))
            for r in range(n_regions):
                if r in out_regions:
                    continue
                # keep ≥1 healthy region so the optimizer has a refuge
                if len(out_regions) >= n_regions - 1:
                    break
                if rng.random() < cfg.outage_on_prob:
                    out_regions.add(r)
                    events.append(TraceEvent(
                        t=t, kind="outage", rate=0.0, device=r,
                        factor=cfg.trace_outage_factor))
        if drifting:
            op = int(rng.integers(n_ops))
            step = float(rng.lognormal(0.0, cfg.selectivity_drift_std))
            lo, hi = cfg.selectivity_drift_bounds
            clipped = float(np.clip(sel_cum[op] * step, lo, hi))
            step = clipped / sel_cum[op]
            sel_cum[op] = clipped
            if step != 1.0:
                events.append(TraceEvent(t=t, kind="drift", rate=0.0,
                                         device=op, factor=step))
    # close any outage still open, so replaying the whole trace returns the
    # fleet to (degrade-)health and back-to-back traces compose
    for r in sorted(out_regions):
        events.append(TraceEvent(t=cfg.trace_len, kind="recover", rate=0.0,
                                 device=r, factor=cfg.trace_outage_factor))
    return events


# -- whole scenarios ----------------------------------------------------------

def random_scenario(rng: np.random.Generator,
                    cfg: ScenarioConfig = ScenarioConfig(),
                    graph: OpGraph | None = None,
                    n_devices: int | None = None,
                    name: str = "scenario") -> Scenario:
    g = graph if graph is not None else random_graph(rng, cfg)
    fleet = random_fleet(rng, cfg, n_devices=n_devices)
    trace = random_trace(rng, fleet.n_devices, cfg,
                         n_regions=int(np.asarray(fleet.region).max()) + 1,
                         n_ops=g.n_ops)
    return Scenario(name=name, graph=g, fleet=fleet, trace=trace)


def scenario_batch(rng: np.random.Generator, n_scenarios: int,
                   cfg: ScenarioConfig = ScenarioConfig(),
                   graph: OpGraph | None = None,
                   n_devices: int | None = None) -> list[Scenario]:
    """N what-if worlds sharing ONE graph and device count — the stackable
    family the batched evaluator scores as a (scenario × placement) grid."""
    g = graph if graph is not None else random_graph(rng, cfg)
    if n_devices is None:
        lo, hi = cfg.n_regions, cfg.devices_per_region
        n_devices = int(rng.integers(lo[0], lo[1] + 1)) \
            * int(rng.integers(hi[0], hi[1] + 1))
    return [
        random_scenario(rng, cfg, graph=g, n_devices=n_devices,
                        name=f"scenario{k}")
        for k in range(n_scenarios)
    ]


def region_scenario_batch(rng: np.random.Generator, n_scenarios: int,
                          cfg: ScenarioConfig = ScenarioConfig(),
                          graph: OpGraph | None = None,
                          n_devices: int | None = None) -> list[Scenario]:
    """N what-if worlds whose fleets are members of ONE RegionFleetFamily
    (shared graph, region layout, device count, and traces per scenario).

    Because every fleet shares the region assignment, ``robust_placement``
    re-packs the batch structurally (pack_region_fleets) and the score grid
    runs the segment-sum path — no (S, V, V) com stack even at 10⁵ devices.
    """
    g = graph if graph is not None else random_graph(rng, cfg)
    fam = region_fleet_family(rng, n_scenarios, cfg, n_devices=n_devices)
    return [
        Scenario(name=f"region_scenario{k}", graph=g, fleet=fam.fleet(k),
                 trace=random_trace(rng, fam.n_devices, cfg,
                                    n_regions=fam.n_regions, n_ops=g.n_ops))
        for k in range(n_scenarios)
    ]
