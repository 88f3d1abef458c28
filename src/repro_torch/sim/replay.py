"""Trace replay and robustness: run generated scenarios through the real
StreamingEngine and pick placements that survive the whole family.

Two instruments:

  * :func:`replay_trace` — drive a StreamingEngine through a generated
    event trace (diurnal/burst ticks, ``degrade``/``remove`` fleet events
    mapped onto the engine's straggler/elasticity hooks) and report the
    modeled-vs-observed latency drift per scenario.  Drift is the evidence
    the paper's model tracks reality as conditions shift.
  * :func:`robust_placement` / :func:`scenario_robust_search` — min–max
    placement selection over a scenario batch.  The implementations live
    in :mod:`repro_torch.search.robust`; these names are delegators with
    the reference's signatures (``device=`` in place of ``use_pallas``),
    imported function-locally so the sim package never imports the search
    layer at import time.

numpy copy of ``repro.sim.replay`` for the PyTorch port: replay drives the
port's :class:`repro_torch.streaming.engine.StreamingEngine`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.costmodel import CostConfig
from repro_torch.core.graph import OpGraph
from repro_torch.core.objectives import ObjectiveSet
from repro_torch.sim.scenarios import MIN_ALIVE_DEVICES, Scenario, TraceEvent

__all__ = ["ReplayStep", "ReplayReport", "apply_fleet_event", "replay_trace",
           "robust_placement", "scenario_robust_search"]


@dataclasses.dataclass
class ReplayStep:
    t: int
    kind: str
    rate: float
    rows_in: int
    modeled_latency: float
    observed_busy: float  # max per-device busy seconds this tick
    n_devices: int
    # full per-device busy vector this tick (V,) — what refit_from_replay
    # fits effective speeds from; observed_busy above keeps the max for
    # backward compatibility
    device_busy: np.ndarray | None = None


@dataclasses.dataclass
class ReplayReport:
    scenario: str
    steps: list[ReplayStep]
    n_degrades: int
    n_removes: int
    n_outages: int = 0
    n_drifts: int = 0

    @property
    def modeled(self) -> np.ndarray:
        return np.array([s.modeled_latency for s in self.steps])

    @property
    def observed(self) -> np.ndarray:
        return np.array([s.observed_busy for s in self.steps])

    @property
    def rates(self) -> np.ndarray:
        return np.array([s.rate for s in self.steps])

    def busy_series(self) -> np.ndarray:
        """(T, V) per-device busy matrix over the trailing run of ticks with
        a constant device count (device losses change V mid-trace, so only
        the suffix after the last removal stacks).  Empty (0, 0) when no
        step recorded a device_busy vector."""
        steps = [s for s in self.steps if s.device_busy is not None]
        if not steps:
            return np.zeros((0, 0))
        v = steps[-1].n_devices
        tail = []
        for s in reversed(steps):
            if s.n_devices != v:
                break
            tail.append(s.device_busy)
        return np.stack(tail[::-1])

    def drift(self) -> dict:
        """Modeled-vs-observed latency drift over the trace.

        The engine's observed busy time and the model's latency live in
        different units, so drift is measured on *normalized* series: the
        std of the per-tick ratio around its mean (0 ⇒ the model tracks
        observation perfectly up to a constant factor)."""
        m, o = self.modeled, self.observed
        keep = (m > 0) & (o > 0)
        if keep.sum() < 2:
            return {"ratio_mean": float("nan"), "ratio_rel_std": float("nan"),
                    "n_ticks": int(keep.sum())}
        r = o[keep] / m[keep]
        return {"ratio_mean": float(r.mean()),
                "ratio_rel_std": float(r.std() / (r.mean() + 1e-12)),
                "n_ticks": int(keep.sum())}


def apply_fleet_event(engine, ev: TraceEvent, alive: list[int],
                      beta: float = 0.0,
                      reoptimize: bool = True) -> str | None:
    """Apply one non-tick trace event to the engine, remapping the event's
    original-fleet device id through the ``alive`` list (mutated on
    removals).  Returns the event kind when it was applied, None when it was
    dropped (dead device, or a removal blocked by the
    :data:`repro_torch.sim.scenarios.MIN_ALIVE_DEVICES` floor).

    Shared by :func:`replay_trace` (engine self-heals: ``reoptimize=True``)
    and the reference's closed-loop controller (``repro.adapt`` passes
    ``reoptimize=False`` — the controller owns re-placement)."""
    if ev.kind == "degrade":
        if ev.device not in alive:
            return None
        engine.apply_event("degrade", alive.index(ev.device),
                           factor=ev.factor, beta=beta,
                           reoptimize=reoptimize)
        return ev.kind
    if ev.kind == "remove":
        if ev.device not in alive or len(alive) <= MIN_ALIVE_DEVICES:
            return None
        engine.apply_event("remove", alive.index(ev.device), beta=beta,
                           reoptimize=reoptimize)
        alive.remove(ev.device)
        return ev.kind
    if ev.kind in ("outage", "recover", "drift"):
        # region ids (outage/recover) and operator ids (drift) survive
        # removals unchanged — no remapping needed
        engine.apply_event(ev.kind, ev.device, factor=ev.factor, beta=beta,
                           reoptimize=reoptimize)
        return ev.kind
    raise ValueError(f"unknown trace event kind {ev.kind!r}")


def replay_trace(engine, trace: list[TraceEvent], rng: np.random.Generator,
                 row_width: int = 4, beta: float = 0.0,
                 name: str = "scenario") -> ReplayReport:
    """Drive ``engine`` (repro_torch.streaming.engine.StreamingEngine) through the
    trace.  Device ids in fleet events index the *original* fleet; removals
    shift the survivors, so ids are remapped through the engine's live
    device count (events on already-dead devices are dropped).

    Removal floor: removals are skipped once only
    :data:`repro_torch.sim.scenarios.MIN_ALIVE_DEVICES` (= 2) devices remain —
    the same invariant ``random_trace`` enforces at generation time, so
    hand-built traces (or traces replayed against a smaller fleet) can
    never strand the engine below 2 devices either.

    Beyond the classic per-device events, traces may carry the
    time-correlated realism events ``outage`` / ``recover`` (whole-region
    failures; counted in ``n_outages``) and ``drift`` (runtime selectivity
    drift; counted in ``n_drifts``) — see
    :func:`repro_torch.sim.scenarios.random_trace`."""
    steps: list[ReplayStep] = []
    counts = {"degrade": 0, "remove": 0, "outage": 0, "drift": 0}
    alive = list(range(engine.fleet.n_devices))
    for ev in trace:
        if ev.kind in ("rate", "burst"):
            rows = max(int(ev.rate), 1)
            batch = rng.normal(size=(rows, row_width))
            rep = engine.run_batch(batch)
            steps.append(ReplayStep(
                t=ev.t, kind=ev.kind, rate=ev.rate, rows_in=rep.rows_in,
                modeled_latency=rep.modeled_latency,
                observed_busy=float(rep.device_busy.max(initial=0.0)),
                n_devices=engine.fleet.n_devices,
                device_busy=rep.device_busy.copy()))
        else:
            applied = apply_fleet_event(engine, ev, alive, beta=beta)
            if applied in ("degrade", "remove", "outage", "drift"):
                counts[applied] += 1
    return ReplayReport(scenario=name, steps=steps,
                        n_degrades=counts["degrade"],
                        n_removes=counts["remove"],
                        n_outages=counts["outage"],
                        n_drifts=counts["drift"])


def robust_placement(graph: OpGraph, scenarios: list[Scenario],
                     rng: np.random.Generator, n_candidates: int = 256,
                     cfg: CostConfig = CostConfig(), beta: float = 0.0,
                     dq: float | np.ndarray = 0.0, sparsity: float = 0.5,
                     extra_candidates: list[np.ndarray] | None = None,
                     device=None,
                     objectives: ObjectiveSet | None = None):
    """Min–max what-if selection over a scenario batch — a delegator to
    :func:`repro_torch.search.robust.robust_placement` (the search
    subsystem's decision layer), returning ``(x_best, worst_score, grid)``."""
    from repro_torch.search.robust import robust_placement as impl

    return impl(graph, scenarios, rng, n_candidates=n_candidates, cfg=cfg,
                beta=beta, dq=dq, sparsity=sparsity,
                extra_candidates=extra_candidates, device=device,
                objectives=objectives)


def scenario_robust_search(graph: OpGraph, scenarios: list[Scenario],
                           rng: np.random.Generator, n_candidates: int = 512,
                           cost_cfg: CostConfig = CostConfig(),
                           beta: float = 0.0,
                           dq: float | np.ndarray = 0.0,
                           sparsity: float = 0.5, warm_start: bool = True,
                           objectives: ObjectiveSet | None = None,
                           **kwargs):
    """Optimizer-grade min–max robust search — a delegator to
    :func:`repro_torch.search.robust.scenario_robust_search`, which also
    accepts the search layer's joint-DQ extensions
    (``co_optimize_dq=True, dq_steps=..., dq_coupling=...``) and
    ``device=`` through ``**kwargs``."""
    from repro_torch.search.robust import scenario_robust_search as impl

    return impl(graph, scenarios, rng, n_candidates=n_candidates,
                cost_cfg=cost_cfg, beta=beta, dq=dq, sparsity=sparsity,
                warm_start=warm_start, objectives=objectives, **kwargs)
