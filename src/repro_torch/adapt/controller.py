"""The closed-loop adaptive controller — the port of
``repro.adapt.controller``.

``AdaptiveController`` drives a :class:`repro_torch.streaming.engine.
StreamingEngine` through a trace tick by tick and closes the paper's
calibrate → optimize loop at runtime:

  observe ──► drift? ──► refit (core.calibration.refit_from_replay)
     ▲                      │
     │                      ▼
  reconfig ◄── worth it? ◄── re-optimize (one score_grid, warm-start)

The controller's WORLD MODEL is a belief it maintains itself (the fleet it
was handed at start, recalibrated from observations); the engine's true
fleet drifts away through trace events (degrades, Markov region outages,
selectivity drift).  Every tick it compares the believed model's latency
against the observed latency and, when the normalized drift
(:func:`repro_torch.core.calibration.normalized_drift`) crosses a threshold:

  1. re-fits per-device slowdowns and the global com scale from the
     window's busy/latency series (``refit_from_replay``), adopting the new
     belief only when it explains the window better;
  2. re-optimizes the placement — and, with ``co_optimize_dq``, the
     quality knob — in ONE ``BatchedEvaluator.score_grid`` dispatch over
     :func:`repro_torch.search.candidates.incumbent_candidates` (the
     incumbent always included, so re-optimization can never regress the
     belief score) against the believed fleet and its jittered (or
     posterior-sampled) copies, crossed analytically with the dq grid;
  3. charges the reconfiguration cost (state-movement bytes priced by the
     believed com model —
     :func:`repro_torch.adapt.regret.reconfiguration_cost`) and only
     switches when the modeled gain amortizes it.

Decisions are deterministic given (engine with ``observed="work"``, trace,
rng seed).  Dispatch count is O(reconfigurations), not O(ticks).

The scenario fleets are dense ``ExplicitFleet``s, so each dispatch is one
K1 launch per scenario on the card.  ``device`` takes the place of the
reference's default backend: ``None`` is the card (and raises without
CUDA), ``"cpu"`` runs K1's plain version.  The grid comes back to the host
once per re-optimization and every decision — the min–max, the exploration
bonus, the amortization gate — is float64 numpy, so first-occurrence
tie-breaking is the reference's.  Everything else (refits, the belief, the
regret oracle) is the reference's numpy, copied.  Besides the reference's
spans (``adapt.reoptimize``, ``adapt.refit``) the loop times its world
events (``adapt.event``) and its hindsight oracle (``adapt.oracle``), so a
trace splits the wall between the engine, the world, the oracle and the
controller.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch import obs
from repro_torch.adapt.regret import RegretReport, reconfiguration_cost
from repro_torch.core.calibration import (ReplayWindow, fit_work_unit,
                                          normalized_drift, refit_from_replay)
from repro_torch.core.costmodel import CostConfig, latency, objective_F
from repro_torch.kernels import dispatch
from repro_torch.sim.replay import apply_fleet_event
from repro_torch.sim.scenarios import TraceEvent

__all__ = ["AdaptiveConfig", "AdaptiveController", "run_adaptive"]


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the closed loop.

    ``window`` ticks of observations feed each drift estimate / refit;
    adaptation triggers when the drift signal exceeds ``drift_threshold``
    (RMS of observed/modeled − 1, so 0.5 ≈ model off by 50%) and at least
    ``cooldown`` ticks have passed since the last adaptation.  A switch
    must buy back its reconfiguration charge within ``amortize_ticks``
    ticks of modeled improvement.  ``beta``/``dq`` are paper eq. 8's
    quality trade-off; ``co_optimize_dq`` searches the dq grid jointly
    with the placement in the same dispatch.

    ``use_belief`` maintains an explicit
    :class:`repro_torch.belief.BeliefState`
    (refits write posterior updates into it; pass a ``prior`` to the
    controller for cold-start priors).  On its own it is passive
    bookkeeping — decisions and the rng stream are BITWISE identical to
    the legacy path (pinned in tests/test_adaptive.py).  The belief starts
    driving decisions through ``belief_sampling`` (robust scenarios are
    posterior samples instead of fixed ``robust_jitter`` noise) and
    ``probe_epsilon`` (probing candidates keep ε mass on high-uncertainty
    devices, adopted when the exploration bonus justifies the price);
    ``belief_decay`` ages observation counts per refit so stale evidence
    relaxes toward the prior."""

    window: int = 6
    drift_threshold: float = 0.5
    # emergency fast path: drift beyond fast_factor × drift_threshold
    # adapts with only 2 observed ticks instead of waiting for the full
    # window — catastrophic shifts (a region outage under the current
    # placement) are exactly when reaction delay is most expensive
    fast_factor: float = 6.0
    cooldown: int = 4
    n_candidates: int = 64
    jitter: float = 0.25
    # belief-robust re-optimization: the candidate batch is scored min–max
    # over `robust_scenarios` lognormal-jittered copies of the believed
    # fleet (the belief is an ESTIMATE — hedging against its error keeps
    # reconfigurations from over-concentrating on links the controller has
    # not observed recently).  1 ⇒ pure point-belief optimization.
    robust_scenarios: int = 4
    robust_jitter: float = 0.4
    oracle_candidates: int = 32
    beta: float = 0.0
    dq: float = 0.0
    co_optimize_dq: bool = False
    dq_steps: int = 5
    state_bytes_per_op: float = 0.25
    amortize_ticks: float = 20.0
    row_width: int = 4
    # belief layer (repro_torch.belief) — all off by default: the legacy
    # controller path stays bitwise intact
    use_belief: bool = False
    belief_sampling: bool = False
    probe_epsilon: float = 0.0
    probe_top_k: int = 2
    prior_strength: float = 4.0
    belief_decay: float = 0.8

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be ≥ 2 ticks (a drift estimate "
                             f"needs two points), got {self.window}")


def _renorm(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(x.sum(axis=1, keepdims=True), 1e-9)


class AdaptiveController:
    """One controller per (engine, trace) run; see the module docstring for
    the loop it closes.  Use :func:`run_adaptive` for the one-call form.
    ``device`` is where the re-optimization grids are scored (``None`` →
    the card; ``"cpu"`` → the plain versions)."""

    def __init__(self, engine, cfg: AdaptiveConfig = AdaptiveConfig(),
                 name: str = "adaptive", prior=None, device=None):
        from repro_torch.core.devices import ExplicitFleet
        from repro_torch.sim.batched import BatchedEvaluator

        self.device = dispatch.resolve_device(device)
        self.engine = engine
        self.cfg = cfg
        self.name = name
        self.graph = engine.graph.meta
        self.cost_cfg = CostConfig(alpha=engine.cfg.alpha)
        fleet = engine.fleet
        self.believed = ExplicitFleet(
            com_cost=np.asarray(fleet.com_matrix(), dtype=np.float64).copy(),
            speed=np.asarray(fleet.effective_speed(),
                             dtype=np.float64).copy(),
            available=None if fleet.available is None
            else np.asarray(fleet.available, dtype=bool).copy(),
            region=np.asarray(fleet.region).copy())
        self.believed_graph = self.graph  # selectivities re-fit over time
        self.com_scale = 1.0
        self.work_unit = float("nan")  # calibrated on the first full window
        self.dq = float(cfg.dq)
        # ONE evaluator for every re-optimization: the believed fleet is
        # data to the grid, so recalibrations reuse it (only a material
        # selectivity re-fit rebuilds it — the graph is structure)
        self._evaluator = BatchedEvaluator(self.graph, self.cost_cfg,
                                           device=self.device)
        self._evaluator_graph = self.graph
        self.controller_dispatches = 0
        self.oracle_dispatches = 0
        # explicit belief layer (None = legacy point-estimate controller)
        self.belief = None
        self._pending_prior_adapt = False
        if cfg.use_belief:
            from repro_torch.belief import BeliefState, apply_degrade

            self.belief = BeliefState.from_fleet(
                self.believed, graph=self.graph, prior=prior,
                prior_strength=cfg.prior_strength)
            if prior is not None:
                # cold start: adopt the prior's predicted slowdowns as the
                # initial belief (a fresh fleet is no longer assumed
                # healthy) and re-optimize at the first observed tick
                d0 = self.belief.posterior_mean_degrade()
                if float(np.max(np.abs(np.log(d0)))) > 1e-9:
                    self.believed = apply_degrade(self.believed, d0)
                    self.belief.commit(d0)
                    self._pending_prior_adapt = True

    # -- belief-side scoring --------------------------------------------------
    def _believed_latency(self, x: np.ndarray) -> float:
        return latency(self.believed_graph, self.believed, x, self.cost_cfg)

    def _reoptimize(self, rng: np.random.Generator
                    ) -> tuple[np.ndarray, float, float, float]:
        """One-dispatch belief-robust re-optimization.

        The warm-start candidate batch (incumbent first, uniform fallback
        last) is scored against ``robust_scenarios`` jittered copies of the
        believed fleet in ONE ``score_grid`` dispatch; the dq axis expands
        analytically (the same ``/(1 + β·dq)`` trick the search layer
        uses) and the min–max candidate wins — a placement hedged against
        belief error, co-optimized with its quality knob.

        With the belief layer on, the scenario copies can be posterior
        samples (``belief_sampling`` — hedging follows the posterior
        variance instead of fixed jitter) and ``probe_epsilon`` rides
        probing variants of the incumbent in the SAME batch (zero extra
        dispatches), selected under an exploration bonus that discounts a
        candidate's score by the uncertainty mass it would observe.
        Returns (x_best, dq_best, score_best, score_incumbent)."""
        from repro_torch.core.placement import uniform_placement
        from repro_torch.search.candidates import (dq_grid,
                                                   incumbent_candidates,
                                                   probe_candidates)
        from repro_torch.sim.batched import pack_fleets, pack_placements
        from repro_torch.sim.scenarios import perturbed_fleet

        cfg = self.cfg
        if self._evaluator_graph is not self.believed_graph:
            from repro_torch.sim.batched import BatchedEvaluator
            self._evaluator = BatchedEvaluator(self.believed_graph,
                                               self.cost_cfg,
                                               device=self.device)
            self._evaluator_graph = self.believed_graph
        avail = self.believed.availability(self.graph.n_ops)
        cands = incumbent_candidates(self.engine.x, avail, rng,
                                     cfg.n_candidates, jitter=cfg.jitter)
        n_base = cands.shape[0]
        std = None
        if self.belief is not None and cfg.probe_epsilon > 0.0:
            std = np.sqrt(self.belief.posterior_var())
            probes = probe_candidates(self.engine.x, avail, std,
                                      cfg.probe_epsilon, cfg.probe_top_k)
        else:
            probes = np.empty((0,) + self.engine.x.shape)
        cands = np.concatenate(
            [cands, probes,
             uniform_placement(self.graph.n_ops, avail)[None]])
        if cfg.co_optimize_dq and cfg.beta > 0.0:
            dqs = dq_grid(cfg.beta, steps=cfg.dq_steps, include=(self.dq,))
        else:
            dqs = np.array([self.dq])
        if self.belief is not None and cfg.belief_sampling:
            fleets = [self.believed] + self.belief.sample_fleets(
                self.believed, rng, max(cfg.robust_scenarios - 1, 0))
        else:
            fleets = [self.believed] + [
                perturbed_fleet(self.believed, rng, cfg.robust_jitter)
                for _ in range(max(cfg.robust_scenarios - 1, 0))]
        with obs.span("adapt.reoptimize", P=int(cands.shape[0]),
                      S=len(fleets), D=int(np.size(dqs))) as sp:
            lat = sp.sync(self._evaluator.score_grid(
                pack_placements(list(cands)), pack_fleets(fleets),
                dq=0.0, beta=0.0)).cpu().numpy().astype(np.float64)  # (S, P)
        self.controller_dispatches += 1
        reg = obs.registry()
        if reg.enabled:
            reg.counter("adapt.reoptimize.dispatches").add(1)
        denom = 1.0 + cfg.beta * np.asarray(dqs, dtype=np.float64)
        worst = (lat[:, :, None] / denom[None, None, :]).max(axis=0)  # (P, D)
        sel = worst
        if std is not None and np.any(std > 0.0):
            # exploration bonus: candidate p's score shrinks by up to ε for
            # the fraction of posterior-std mass its placement would
            # observe (a device counts fully once it holds ≥ ε mean mass).
            # The bonus is the controller's price of information — it
            # participates in BOTH selection and the amortization gate, so
            # a probe is adopted exactly when the information is worth the
            # move.
            eps = float(cfg.probe_epsilon)
            mass = cands.mean(axis=1)                      # (P, V)
            cov = (std[None, :] * np.minimum(mass / eps, 1.0)).sum(axis=1) \
                / std.sum()
            sel = worst * (1.0 - eps * cov[:, None])
        i, d = divmod(int(np.argmin(sel)), sel.shape[1])
        if reg.enabled and n_base <= i < n_base + probes.shape[0]:
            reg.counter("belief.probes").add(1)
        inc_d = int(np.argmin(np.abs(np.asarray(dqs) - self.dq)))
        return (np.asarray(cands[i], dtype=np.float64), float(dqs[d]),
                float(sel[i, d]), float(sel[0, inc_d]))

    # -- truth-side scoring (regret accounting only) --------------------------
    def _true_F(self, true_graph, x: np.ndarray, dq: float) -> float:
        lat = latency(true_graph, self.engine.fleet, x, self.cost_cfg)
        return objective_F(lat, dq, self.cfg.beta)

    def _oracle_reoptimize(self, true_graph, oracle_x: np.ndarray,
                           oracle_dq: float, extra: list[np.ndarray],
                           rng: np.random.Generator
                           ) -> tuple[np.ndarray, float]:
        """Hindsight reference: scalar-oracle re-optimization against the
        TRUE fleet and TRUE (drift-included) graph.  Accounting only — the
        controller never sees this; scored with the float64 oracle, so it
        issues no dispatches of its own."""
        from repro_torch.search.candidates import dq_grid, incumbent_candidates

        cfg = self.cfg
        avail = self.engine.fleet.availability(self.graph.n_ops)
        cands = list(incumbent_candidates(oracle_x, avail, rng,
                                          cfg.oracle_candidates,
                                          jitter=cfg.jitter))
        cands += [np.asarray(x, dtype=np.float64) for x in extra]
        dqs = dq_grid(cfg.beta, steps=cfg.dq_steps, include=(oracle_dq,)) \
            if cfg.beta > 0.0 else np.array([oracle_dq])
        best = (math.inf, oracle_x, oracle_dq)
        for x in cands:
            lat = latency(true_graph, self.engine.fleet, x, self.cost_cfg)
            for dq in dqs:
                f = objective_F(lat, float(dq), cfg.beta)
                if f < best[0]:
                    best = (f, x, float(dq))
        return best[1], best[2]

    # -- the loop -------------------------------------------------------------
    def run(self, trace: list[TraceEvent],
            rng: np.random.Generator) -> RegretReport:
        cfg = self.cfg
        eng = self.engine
        alive = list(range(eng.fleet.n_devices))
        static_x = eng.x.copy()
        oracle_x, oracle_dq = eng.x.copy(), self.dq
        oracle_dirty = True
        # per-tick records
        f_static, f_adaptive, f_oracle = [], [], []
        charges, drift_series = [], []
        reconfig_ticks, refit_ticks = [], []
        # observation window (cleared on belief change / device-count change)
        w_rates, w_busy, w_obs, w_mod, w_xs = [], [], [], [], []
        w_rin, w_rout = [], []
        ticks_since_adapt = cfg.cooldown
        # a structural fleet event was applied and not yet adapted to: the
        # controller KNOWS the world changed (it applied the event), it just
        # doesn't know the magnitude — adapt as soon as a fresh window
        # fills, even if the drift signal stays quiet (a wrong belief can
        # look calibrated when the current placement avoids the links it is
        # wrong about)
        pending_structural = False

        def clear_window():
            w_rates.clear(); w_busy.clear(); w_obs.clear()
            w_mod.clear(); w_xs.clear(); w_rin.clear(); w_rout.clear()

        def make_window(tail):
            return ReplayWindow(
                rates=np.array(w_rates[tail]),
                busy=np.stack(w_busy[tail]),
                observed_latency=np.array(w_obs[tail]),
                xs=np.stack(w_xs[tail]),
                op_rows_in=np.stack(w_rin[tail]),
                op_rows_out=np.stack(w_rout[tail]))

        for ev in trace:
            if ev.kind not in ("rate", "burst"):
                idx = alive.index(ev.device) if ev.device in alive else None
                with obs.span("adapt.event", kind=ev.kind):
                    applied = apply_fleet_event(eng, ev, alive,
                                                beta=cfg.beta,
                                                reoptimize=False)
                if applied == "remove":
                    # device loss is OBSERVABLE — belief, baselines and the
                    # window all shrink with the world
                    keep = [u for u in range(self.believed.n_devices)
                            if u != idx]
                    self.believed, _ = self.believed.without_devices([idx])
                    if self.belief is not None:
                        self.belief = self.belief.without_devices(keep)
                    static_x = _renorm(static_x[:, keep])
                    oracle_x = _renorm(oracle_x[:, keep])
                if applied in ("degrade", "outage", "recover", "remove"):
                    # a structural world change: pre-event observations
                    # would make a refit fit an average of two worlds —
                    # start the window fresh (drift detection then needs
                    # `window` new ticks, a deliberate reaction delay).
                    # Gradual "drift" events deliberately do NOT reset it:
                    # chasing slow selectivity drift across a window is the
                    # controller's job, not noise.
                    clear_window()
                    pending_structural = True
                if applied is not None:
                    oracle_dirty = True
                continue

            # ---- tick: run the batch, observe ----------------------------
            rows = max(int(ev.rate), 1)
            rep = eng.run_batch(rng.normal(size=(rows, cfg.row_width)))
            observed = rep.true_latency         # the WORLD's true latency
            modeled = self.com_scale * self._believed_latency(eng.x)
            w_rates.append(ev.rate); w_busy.append(rep.device_busy.copy())
            w_obs.append(observed); w_mod.append(modeled)
            w_xs.append(eng.x.copy())
            w_rin.append(np.asarray(rep.op_rows_in, dtype=np.float64))
            w_rout.append(np.asarray(rep.op_rows_out, dtype=np.float64))
            ticks_since_adapt += 1
            if not np.isfinite(self.work_unit) \
                    and len(w_obs) >= cfg.window:
                # one-time unit calibration on the first full window, while
                # the belief is still trusted — later refits anchor their
                # slowdown estimates to this constant (fit_work_unit)
                self.work_unit = fit_work_unit(
                    self.believed_graph, self.believed,
                    make_window(slice(None)))

            # ---- regret accounting on the true world ---------------------
            true_g = eng.true_graph()
            if oracle_dirty:
                with obs.span("adapt.oracle"):
                    oracle_x, oracle_dq = self._oracle_reoptimize(
                        true_g, oracle_x, oracle_dq, [static_x, eng.x], rng)
                oracle_dirty = False
            charge = 0.0

            # ---- drift watch → refit → re-optimize -----------------------
            tail = slice(-cfg.window, None)
            drift = normalized_drift(np.array(w_obs[tail]),
                                     np.array(w_mod[tail]))
            drift_series.append(drift)
            if np.isfinite(drift):
                # Perfetto counter track: the controller's trigger signal
                obs.counter_sample("adapt.drift", drift)
            triggered = (np.isfinite(drift)
                         and drift > cfg.drift_threshold) \
                or pending_structural
            fast = (len(w_obs) >= 2 and np.isfinite(drift)
                    and drift > cfg.fast_factor * cfg.drift_threshold)
            do_adapt = (ticks_since_adapt >= cfg.cooldown
                        and ((len(w_obs) >= cfg.window and triggered)
                             or fast))
            # cold-start prior adaptation: the prior predicted a degraded
            # world, so re-optimize at the FIRST observed tick instead of
            # waiting a full drift window (no refit — there is nothing to
            # fit yet; one extra dispatch total)
            initial = self._pending_prior_adapt and len(w_obs) >= 1
            if do_adapt or initial:
                self._pending_prior_adapt = False
                if do_adapt:
                    pending_structural = False
                    if self.belief is not None:
                        # evidence ages one adaptation epoch before the new
                        # window lands: variance re-inflates, stale
                        # estimates relax toward the prior
                        self.belief.decay(cfg.belief_decay)
                    with obs.span("adapt.refit", ticks=len(w_obs)):
                        refit = refit_from_replay(
                            self.believed_graph, self.believed,
                            make_window(tail), self.cost_cfg,
                            work_unit=self.work_unit, belief=self.belief)
                    reg = obs.registry()
                    if reg.enabled and self.belief is not None:
                        reg.counter("belief.updates").add(1)
                        reg.gauge("belief.variance").set(
                            float(np.mean(self.belief.posterior_var())))
                    if not np.isfinite(refit.post_drift) \
                            or refit.post_drift <= refit.pre_drift:
                        self.believed = refit.fleet
                        self.com_scale = 1.0  # refit folded the scale in
                        if self.belief is not None:
                            self.belief.commit(refit.degrade)
                        if np.max(np.abs(refit.sel_scale - 1.0)) > 0.02:
                            # material selectivity drift: adopt the re-fit
                            # graph (the next re-optimization rebuilds its
                            # evaluator)
                            self.believed_graph = refit.graph
                        refit_ticks.append(ev.t)
                        if reg.enabled:
                            reg.counter("adapt.refits.adopted").add(1)
                    elif reg.enabled:
                        # refit explained the window WORSE — belief kept
                        reg.counter("adapt.refits.rejected").add(1)
                else:
                    reg = obs.registry()
                x_new, dq_new, score_new, score_inc = self._reoptimize(rng)
                # gate on the BELIEVED price (all the controller has); the
                # regret account below charges the TRUE price of the move
                cost = reconfiguration_cost(
                    eng.x, x_new, self.graph, self.believed,
                    cfg.state_bytes_per_op)
                if (score_inc - score_new) * cfg.amortize_ticks > cost:
                    if not np.array_equal(x_new, eng.x):
                        charge = reconfiguration_cost(
                            eng.x, x_new, self.graph, eng.fleet,
                            cfg.state_bytes_per_op)
                        reconfig_ticks.append(ev.t)
                        oracle_dirty = True
                        if reg.enabled:
                            reg.counter("adapt.reconfigs").add(1)
                    eng.x = x_new
                    self.dq = dq_new
                ticks_since_adapt = 0
                clear_window()

            f_static.append(self._true_F(true_g, static_x, cfg.dq))
            f_adaptive.append(self._true_F(true_g, eng.x, self.dq))
            f_oracle.append(self._true_F(true_g, oracle_x, oracle_dq))
            charges.append(charge)
            # regret timelines: one Perfetto counter track per policy
            # (main series = the adaptive policy under test)
            obs.counter_sample("adapt.F", f_adaptive[-1],
                               static=f_static[-1], oracle=f_oracle[-1])

        return RegretReport(
            scenario=self.name,
            f_static=np.array(f_static),
            f_adaptive=np.array(f_adaptive),
            f_oracle=np.array(f_oracle),
            reconfig_costs=np.array(charges),
            drift=np.array(drift_series),
            reconfig_ticks=reconfig_ticks,
            refit_ticks=refit_ticks,
            n_refits=len(refit_ticks),
            n_reconfigs=len(reconfig_ticks),
            controller_dispatches=self.controller_dispatches,
            oracle_dispatches=self.oracle_dispatches,
            final_com_scale=self.com_scale)


def run_adaptive(engine, trace: list[TraceEvent], rng: np.random.Generator,
                 cfg: AdaptiveConfig = AdaptiveConfig(),
                 name: str = "adaptive", prior=None,
                 device=None) -> RegretReport:
    """Close the loop over one trace: observe → drift → refit → re-optimize
    → reconfigure, with regret accounting against the static seed placement
    and the per-world-change oracle.  One-call wrapper around
    :class:`AdaptiveController`.  ``prior`` (a :class:`repro_torch.belief.
    LearnedPrior`) seeds the belief for cold starts when
    ``cfg.use_belief``; ``device`` scores the re-optimization grids
    (``None`` → the card, ``"cpu"`` → the plain versions)."""
    return AdaptiveController(engine, cfg, name=name, prior=prior,
                              device=device).run(trace, rng)
