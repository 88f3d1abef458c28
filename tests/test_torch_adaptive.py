"""The port's closed loop against the JAX package: the replay refit
(``core/calibration.py``), the regret accounting (``adapt/regret.py``) and
the adaptive controller (``adapt/controller.py``), on the reference tests'
inputs and fixtures.

Bars:

* the copied numpy (windows, refits, work units, drift, reconfiguration
  costs) is bitwise equal to the reference's;
* the controller makes the JAX controller's decisions — the same
  ``reconfig_ticks``, ``refit_ticks``, ``n_refits``, ``n_reconfigs`` and
  dispatch counts, the engine's final ``x`` bitwise — and its F series
  (``f_static``, ``f_adaptive``, ``f_oracle``, ``reconfig_costs``,
  ``drift``) agree within 1e-9 relative;
* ``use_belief=True`` with every belief knob passive is bitwise the legacy
  run in the port too.

The port runs on the CPU here (``device="cpu"``: K1's plain version); the
JAX package runs as its own tests run it.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.adapt as JA  # noqa: E402
import repro.adapt.regret as JR  # noqa: E402
import repro.belief as JB  # noqa: E402
import repro.core.calibration as JC  # noqa: E402
import repro.core.costmodel as JCM  # noqa: E402
import repro.core.devices as JD  # noqa: E402
import repro.core.graph as JG  # noqa: E402
import repro.core.placement as JP  # noqa: E402
import repro.sim as JS  # noqa: E402
import repro.sim.scenarios as JSC  # noqa: E402
import repro.streaming.engine as JE  # noqa: E402
import repro.streaming.operators as JO  # noqa: E402
import repro_torch.adapt as TA  # noqa: E402
import repro_torch.adapt.regret as TR  # noqa: E402
import repro_torch.belief as TB  # noqa: E402
import repro_torch.core.calibration as TC  # noqa: E402
import repro_torch.core.costmodel as TCM  # noqa: E402
import repro_torch.core.devices as TD  # noqa: E402
import repro_torch.core.graph as TG  # noqa: E402
import repro_torch.core.placement as TP  # noqa: E402
import repro_torch.sim as TS  # noqa: E402
import repro_torch.sim.scenarios as TSC  # noqa: E402
import repro_torch.streaming.engine as TE  # noqa: E402
import repro_torch.streaming.operators as TO  # noqa: E402

CPU = "cpu"
F_REL = 1e-9


def _bundle(A, B, C, CM, D, G, P, S, SC, E, O):
    return types.SimpleNamespace(
        adapt=A, belief=B, cal=C, costmodel=CM, ExplicitFleet=D.ExplicitFleet,
        Operator=G.Operator, OpGraph=G.OpGraph,
        uniform_placement=P.uniform_placement, sim=S, scen=SC,
        StreamingEngine=E.StreamingEngine, ops=O)


JAX = _bundle(JA, JB, JC, JCM, JD, JG, JP, JS, JSC, JE, JO)
PORT = _bundle(TA, TB, TC, TCM, TD, TG, TP, TS, TSC, TE, TO)


def _run(m, engine, trace, rng, cfg, **kw):
    """run_adaptive in either package (the port on the CPU route)."""
    if m is PORT:
        kw["device"] = CPU
    return m.adapt.run_adaptive(engine, trace, rng, cfg, **kw)


# -- replay windows and refits (tests/test_refit.py's inputs) ------------------

def _chain(m, n_ops, sel=1.2, work=0.5):
    ops = [m.Operator(f"op{i}", selectivity=sel, work=work)
           for i in range(n_ops)]
    return m.OpGraph(ops, [(i, i + 1) for i in range(n_ops - 1)])


def _base_com(rng, v):
    com = rng.uniform(0.5, 2.0, (v, v))
    com = (com + com.T) / 2.0
    np.fill_diagonal(com, 0.0)
    return com


def _window_arrays(seed, v, factor, com_scale, t_ticks=10, work_unit=1e-6,
                   uniform=False):
    """tests/test_refit.py's _window_from_truth as plain arrays: the busy and
    latency series a world with degrade d_true and a com scale emits."""
    rng = np.random.default_rng(seed)
    graph = _chain(JAX, 4)
    com = _base_com(rng, v)
    d_true = np.full(v, factor) if uniform else np.ones(v)
    if not uniform:
        d_true[int(rng.integers(v))] = factor
    true_com = com * np.outer(d_true, d_true) * com_scale
    np.fill_diagonal(true_com, 0.0)
    true_fleet = JAX.ExplicitFleet(com_cost=true_com, speed=1.0 / d_true)
    xs = np.stack([rng.dirichlet(np.ones(v), size=graph.n_ops)
                   for _ in range(t_ticks)])
    rates = rng.uniform(50.0, 300.0, t_ticks)
    cum = graph.cumulative_rates()
    wk = np.array([op.work * cum[i] for i, op in enumerate(graph.operators)])
    busy = work_unit * np.einsum("i,tiu->tu", wk, xs) \
        * rates[:, None] * d_true[None, :]
    obs = np.array([JAX.costmodel.latency(graph, true_fleet, x) for x in xs])
    return com, dict(rates=rates, busy=busy, observed_latency=obs, xs=xs)


def _rows_arrays(seed):
    """tests/test_refit.py's row-counter window (op 1 drifted to s = 0.5)."""
    rng = np.random.default_rng(seed)
    v, t = 4, 6
    com = _base_com(rng, v)
    xs = np.stack([rng.dirichlet(np.ones(v), size=3) for _ in range(t)])
    rows_in = np.stack([[100.0, 100.0, 50.0]] * t)
    rows_out = np.stack([[100.0, 50.0, 50.0]] * t)
    busy = 1e-6 * np.einsum("ti,tiu->tu", rows_in * 0.5, xs) \
        * rng.uniform(0.8, 3.0, v)[None, :]
    graph = _chain(JAX, 3, sel=1.0)
    obs = np.array([JAX.costmodel.latency(graph, JAX.ExplicitFleet(
        com_cost=com), x) * (1.0 + 0.1 * k) for k, x in enumerate(xs)])
    return com, dict(rates=np.full(t, 100.0), busy=busy,
                     observed_latency=obs, xs=xs, op_rows_in=rows_in,
                     op_rows_out=rows_out)


def _refit_case(name):
    """(n_ops, sel, region, window arrays, com, work_unit kwarg)."""
    if name == "straggler":
        com, arrays = _window_arrays(11, 6, 7.5, 1.8)
        return 4, 1.2, None, arrays, com, {}
    if name == "straggler_v8":
        com, arrays = _window_arrays(2024, 8, 19.0, 2.7)
        return 4, 1.2, None, arrays, com, {}
    if name == "uniform_anchored":
        com, arrays = _window_arrays(3, 6, 8.0, 1.0, uniform=True)
        return 4, 1.2, None, arrays, com, {"work_unit": 1e-6}
    if name == "blind_region":
        com, arrays = _window_arrays(4, 6, 16.0, 1.0)
        xs = arrays["xs"].copy()
        xs[:, :, 5] = 0.0
        arrays["xs"] = xs / xs.sum(axis=2, keepdims=True)
        arrays["busy"] = arrays["busy"] * (arrays["xs"].sum(axis=1) > 0)
        return 4, 1.2, np.array([0, 0, 0, 1, 1, 1]), arrays, com, {}
    com, arrays = _rows_arrays(5)
    return 3, 1.0, np.array([0, 0, 1, 1]), arrays, com, {}


def _refit_pair(name):
    n_ops, sel, region, arrays, com, kw = _refit_case(name)
    out = []
    for m in (JAX, PORT):
        graph = _chain(m, n_ops, sel=sel)
        fleet = m.ExplicitFleet(com_cost=com, region=region)
        window = m.cal.ReplayWindow(**arrays)
        out.append((graph, fleet, window,
                    m.cal.refit_from_replay(graph, fleet, window, **kw)))
    return out


def _equal(a, b):
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _same_fleet(a, b):
    assert np.array_equal(a.com_cost, b.com_cost)
    assert np.array_equal(a.speed, b.speed)
    assert _equal(a.available, b.available) and _equal(a.region, b.region)


@pytest.mark.parametrize("name", ["straggler", "straggler_v8",
                                  "uniform_anchored", "blind_region",
                                  "row_counters"])
def test_refit_from_replay_is_bitwise_the_reference(name):
    (_, _, wj, rj), (_, _, wt, rt) = _refit_pair(name)
    for f in ("rates", "busy", "observed_latency", "xs", "op_rows_in",
              "op_rows_out"):
        assert _equal(getattr(wj, f), getattr(wt, f)), f
    for f in ("com_scale", "degrade", "speed", "sel_scale", "work_unit",
              "n_ticks", "pre_drift", "post_drift", "signal", "obs_weight",
              "op_obs_weight", "posterior_var"):
        assert _equal(getattr(rj, f), getattr(rt, f)), f
    _same_fleet(rj.fleet, rt.fleet)
    assert [op.selectivity for op in rj.graph.operators] == \
        [op.selectivity for op in rt.graph.operators]


@pytest.mark.parametrize("name", ["straggler", "uniform_anchored",
                                  "row_counters"])
def test_fit_work_unit_and_drift_are_bitwise_the_reference(name):
    (gj, fj, wj, _), (gt, ft, wt, _) = _refit_pair(name)
    assert _equal(JC.fit_work_unit(gj, fj, wj), TC.fit_work_unit(gt, ft, wt))
    obs = wj.observed_latency
    for modeled in (obs, obs / 2.0, obs[::-1], np.zeros_like(obs)):
        assert _equal(JC.normalized_drift(obs, modeled),
                      TC.normalized_drift(obs, modeled))


def test_refit_writes_into_a_belief_as_the_reference_does():
    """refit_from_replay(belief=) updates the posterior and carries its
    variance, bitwise in both packages."""
    outs = []
    for m in (JAX, PORT):
        n_ops, sel, region, arrays, com, _ = _refit_case("row_counters")
        graph = _chain(m, n_ops, sel=sel)
        fleet = m.ExplicitFleet(com_cost=com, region=region)
        belief = m.belief.BeliefState.from_fleet(fleet, graph=graph)
        refit = m.cal.refit_from_replay(graph, fleet,
                                        m.cal.ReplayWindow(**arrays),
                                        belief=belief)
        outs.append((refit, belief))
    (rj, bj), (rt, bt) = outs
    assert _equal(rj.posterior_var, rt.posterior_var)
    for f in ("est_log", "obs_count", "op_est_log", "op_obs_count"):
        assert _equal(getattr(bj, f), getattr(bt, f)), f


@pytest.mark.parametrize("bad", ["rates", "xs", "op_rows_in"])
def test_replay_window_refuses_what_the_reference_refuses(bad):
    _, arrays = _window_arrays(1, 4, 2.0, 1.0, t_ticks=3)
    if bad == "rates":
        arrays["rates"] = arrays["rates"][:2]
    elif bad == "xs":
        arrays["xs"] = arrays["xs"][:, :, :3]
    else:
        arrays["op_rows_in"] = np.ones((3, 7))
    msgs = []
    for m in (JAX, PORT):
        with pytest.raises(ValueError) as e:
            m.cal.ReplayWindow(**arrays)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_refit_needs_two_ticks():
    com, arrays = _window_arrays(6, 4, 1.0, 1.0, t_ticks=1)
    with pytest.raises(ValueError, match="≥2 ticks"):
        TC.refit_from_replay(_chain(PORT, 4), PORT.ExplicitFleet(
            com_cost=com), TC.ReplayWindow(**arrays))


def test_window_from_replay_report_is_bitwise_the_reference():
    """tests/test_refit.py's plain-replay window, lifted off each package's
    own ReplayReport."""
    out = []
    for m in (JAX, PORT):
        rng = np.random.default_rng(9)
        ops = [m.ops.source(),
               m.ops.map_op("normalize", lambda r: r - r.mean()),
               m.ops.filter_op("keep", lambda r: r[:, 0] > 0.0,
                               selectivity=0.5)]
        sg = m.ops.StreamGraph(ops, [(0, 1), (1, 2)])
        cfg = m.sim.ScenarioConfig(trace_len=6, base_rate=24.0,
                                   loss_prob=0.0, degrade_prob=0.0)
        s = m.sim.scenario_batch(rng, 1, cfg, graph=sg.meta)[0]
        x = m.uniform_placement(sg.meta.n_ops,
                                np.ones((sg.meta.n_ops, s.n_devices), bool))
        eng = m.StreamingEngine(sg, s.fleet, x, observed="work")
        window = m.cal.ReplayWindow.from_report(
            m.sim.replay_trace(eng, s.trace, rng), x)
        out.append((window, m.cal.refit_from_replay(sg.meta, s.fleet,
                                                     window)))
    (wj, rj), (wt, rt) = out
    for f in ("rates", "busy", "observed_latency", "xs"):
        assert _equal(getattr(wj, f), getattr(wt, f)), f
    assert _equal(rj.degrade, rt.degrade) and rj.com_scale == rt.com_scale


# -- reconfiguration cost (tests/test_adaptive.py:320) -------------------------

def test_reconfiguration_cost_properties():
    g = TG.OpGraph([TG.Operator("a", out_bytes=2.0),
                    TG.Operator("b", out_bytes=4.0)], [(0, 1)])
    com = np.array([[0.0, 1.0, 5.0],
                    [1.0, 0.0, 2.0],
                    [5.0, 2.0, 0.0]])
    fleet = TD.ExplicitFleet(com_cost=com)
    x = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    assert TA.reconfiguration_cost(x, x, g, fleet) == 0.0
    x2 = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    assert TA.reconfiguration_cost(x, x2, g, fleet) == pytest.approx(2.0)
    x3 = np.array([[0.0, 0.5, 0.5], [0.0, 1.0, 0.0]])
    assert TA.reconfiguration_cost(x, x3, g, fleet) == \
        pytest.approx(2.0 * (0.5 * 1.0 + 0.5 * 5.0))
    with pytest.raises(ValueError):
        TA.reconfiguration_cost(x, x[:, :2], g, fleet)


def _transport_case(kind, v, seed):
    """(outflow, inflow, com): jittered and restart moves on a region fleet
    with degraded devices (many tied costs), exact mass ties, and slivers."""
    rng = np.random.default_rng(seed)
    region = np.sort(rng.integers(0, 4, v))
    inter = rng.lognormal(0.0, 0.6, (4, 4))
    inter = (inter + inter.T) / 2.0
    d = rng.choice([1.0, 2.0, 32.0], v, p=[0.8, 0.1, 0.1])
    com = inter[region][:, region] * np.outer(d, d)
    np.fill_diagonal(com, 0.0)
    x_old = np.full(v, 1.0 / v)
    if kind == "jitter":
        x_new = 0.75 * x_old + 0.25 * rng.dirichlet(np.ones(v))
    elif kind == "restart":
        x_new = rng.dirichlet(np.full(v, 0.5))
    elif kind == "ties":
        x_old = rng.integers(0, 4, v).astype(np.float64)
        x_new = rng.permutation(x_old)
        com = np.round(com)
    else:                                      # slivers below 1e-12
        x_new = x_old.copy()
        x_new[: v // 2] += 1e-13
        x_new[v // 2:] -= 1e-13
        x_new[0] += 0.3
        x_new[-1] -= 0.3 / v
    diff = x_new - x_old
    return np.maximum(-diff, 0.0), np.maximum(diff, 0.0), com


@pytest.mark.parametrize("kind", ["jitter", "restart", "ties", "slivers"])
@pytest.mark.parametrize("v,seed", [(3, 0), (17, 1), (64, 2), (300, 3)])
def test_greedy_transport_is_bitwise_the_reference(kind, v, seed):
    """The vectorized scan charges the reference loop's pairs in its order:
    the same float64 sum, bit for bit."""
    out, inn, com = _transport_case(kind, v, seed)
    want = JR._greedy_transport(out, inn, com)
    got = TR._greedy_transport(out, inn, com)
    assert got == want
    assert np.array_equal(out, _transport_case(kind, v, seed)[0])


def test_reconfiguration_cost_is_bitwise_the_reference():
    rng = np.random.default_rng(8)
    com = _base_com(rng, 40)
    gj, gt = (m.OpGraph([m.Operator(f"o{i}", out_bytes=1.0 + i)
                         for i in range(3)], [(0, 1), (1, 2)])
              for m in (JAX, PORT))
    for _ in range(5):
        x0 = rng.dirichlet(np.ones(40), size=3)
        x1 = rng.dirichlet(np.full(40, 0.3), size=3)
        want = JA.reconfiguration_cost(x0, x1, gj,
                                       JD.ExplicitFleet(com_cost=com), 0.25)
        got = TA.reconfiguration_cost(x0, x1, gt,
                                      TD.ExplicitFleet(com_cost=com), 0.25)
        assert got == want


# -- the controller on tests/test_adaptive.py's fixtures -----------------------

CTL = dict(window=3, cooldown=2, drift_threshold=0.3, amortize_ticks=8.0,
           n_candidates=32, oracle_candidates=16)
# benchmarks/bench_adaptive.py's drifting world and controller, cut to 16
# ticks
BENCH_CTL = dict(window=4, cooldown=2, drift_threshold=0.5,
                 amortize_ticks=5.0)


def _stream_graph(m):
    ops = [m.ops.source(),
           m.ops.map_op("normalize",
                        lambda r: (r - r.mean()) / (r.std() + 1e-9)),
           m.ops.filter_op("threshold", lambda r: r[:, 0] > -0.5,
                           selectivity=0.7)]
    return m.ops.StreamGraph(ops, [(0, 1), (1, 2)])


def _engine(m, seed=0, cfg=None):
    """tests/test_adaptive.py's _engine in package ``m``."""
    cfg = cfg or m.sim.ScenarioConfig(trace_len=8, base_rate=32.0,
                                      n_regions=(3, 3),
                                      devices_per_region=(2, 2))
    rng = np.random.default_rng(seed)
    sg = _stream_graph(m)
    s = m.sim.scenario_batch(rng, 1, cfg, graph=sg.meta)[0]
    x = m.uniform_placement(sg.meta.n_ops,
                            np.ones((sg.meta.n_ops, s.n_devices), bool))
    return m.StreamingEngine(sg, s.fleet, x, observed="work")


def _ticks(m, t0, n, rate=32.0):
    return [m.scen.TraceEvent(t=t0 + k, kind="rate", rate=rate)
            for k in range(n)]


def _outage(m, region, pre=4, dwell=14, post=4, factor=32.0):
    ev = m.scen.TraceEvent
    return (_ticks(m, 0, pre)
            + [ev(t=pre, kind="outage", rate=0.0, device=region,
                  factor=factor)]
            + _ticks(m, pre, dwell)
            + [ev(t=pre + dwell, kind="recover", rate=0.0, device=region,
                  factor=factor)]
            + _ticks(m, pre + dwell, post))


def _back_to_back(m, r0, r1, dwell=8, factor=16.0):
    ev = m.scen.TraceEvent
    return (_ticks(m, 0, 4)
            + [ev(t=4, kind="outage", rate=0.0, device=r, factor=factor)
               for r in (r0, r1)]
            + _ticks(m, 4, dwell)
            + [ev(t=4 + dwell, kind="recover", rate=0.0, device=r,
                  factor=factor) for r in (r0, r1)]
            + _ticks(m, 4 + dwell, 4))


def _drifting(m, seed, trace_len=16):
    """bench_adaptive.py's _drifting_scenario, cut to ``trace_len``."""
    rng = np.random.default_rng(seed)
    sg = _stream_graph(m)
    cfg = m.sim.ScenarioConfig(trace_len=trace_len, base_rate=64.0,
                               n_regions=(3, 3), devices_per_region=(2, 3),
                               degrade_prob=0.06, loss_prob=0.01,
                               outage_on_prob=0.05, outage_off_prob=0.06,
                               selectivity_drift_std=0.10)
    s = m.sim.scenario_batch(rng, 1, cfg, graph=sg.meta)[0]
    trace = m.scen.random_trace(
        rng, s.n_devices, cfg, n_regions=int(np.asarray(s.fleet.region).max())
        + 1, n_ops=sg.meta.n_ops)
    x0 = m.uniform_placement(sg.meta.n_ops,
                             np.ones((sg.meta.n_ops, s.n_devices), bool))
    return m.StreamingEngine(sg, s.fleet, x0, observed="work"), trace


def _min_alive(m):
    cfg = m.sim.ScenarioConfig(trace_len=4, n_regions=(3, 3),
                               devices_per_region=(1, 1))
    eng = _engine(m, 3, cfg)
    trace = _ticks(m, 0, 4)
    for d in range(3):
        trace.append(m.scen.TraceEvent(t=4 + d, kind="remove", rate=0.0,
                                       device=d))
        trace += _ticks(m, 5 + d, 2)
    return eng, trace


def _fixture(name, m):
    """(engine, trace, rng seed, AdaptiveConfig keywords) of one fixture."""
    if name == "min_alive_floor":
        return (*_min_alive(m), 0, CTL)
    if name.startswith("drifting"):
        seed = int(name[-1])
        return (*_drifting(m, seed), seed + 100, BENCH_CTL)
    seed = {"back_to_back": 4, "zero_ticks": 2, "one_tick": 2,
            "deterministic": 5}.get(name, 0)
    eng = _engine(m, seed)
    regions = np.asarray(eng.fleet.region)
    if name == "back_to_back":
        return eng, _back_to_back(m, int(regions[0]), int(regions[-1])), 0, \
            CTL
    if name == "zero_ticks":
        return eng, [], 0, CTL
    if name == "one_tick":
        return eng, _ticks(m, 0, 1), 0, CTL
    post = 24 if name == "outage_long_tail" else 4
    trace = _outage(m, int(regions[0]), post=post)
    rng = 9 if name == "deterministic" else 1
    extra = {"co_optimize_dq": dict(beta=0.5, dq=0.2, co_optimize_dq=True),
             "belief_passive": dict(use_belief=True),
             "belief_probing": dict(use_belief=True, belief_sampling=True,
                                    probe_epsilon=0.1)}.get(name, {})
    return eng, trace, rng, dict(CTL, **extra)


FIXTURES = ["outage", "outage_long_tail", "deterministic", "back_to_back",
            "min_alive_floor", "zero_ticks", "one_tick", "drifting0",
            "drifting1", "drifting2", "co_optimize_dq", "belief_passive",
            "belief_probing"]


def _pair_run(name, prior_of=lambda m: None):
    out = []
    for m in (JAX, PORT):
        eng, trace, seed, kw = _fixture(name, m)
        rep = _run(m, eng, trace, np.random.default_rng(seed),
                   m.adapt.AdaptiveConfig(**kw), prior=prior_of(m))
        out.append((rep, eng))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    scale = np.maximum(np.abs(want[keep]), 1e-300)
    return float((np.abs(got[keep] - want[keep]) / scale).max(initial=0.0))


def _same_decisions(rj, rt, ej, et):
    for f in ("reconfig_ticks", "refit_ticks", "n_refits", "n_reconfigs",
              "controller_dispatches", "oracle_dispatches", "n_ticks"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert np.array_equal(et.x, ej.x)
    for f in ("f_static", "f_adaptive", "f_oracle", "reconfig_costs",
              "drift"):
        assert _rel(getattr(rt, f), getattr(rj, f)) <= F_REL, f


@pytest.mark.parametrize("name", FIXTURES)
def test_controller_makes_the_jax_controllers_decisions(name):
    (rj, ej), (rt, et) = _pair_run(name)
    _same_decisions(rj, rt, ej, et)
    assert rt.final_com_scale == rj.final_com_scale
    assert rt.summary().keys() == rj.summary().keys()
    if name == "min_alive_floor":
        assert et.fleet.n_devices == TS.MIN_ALIVE_DEVICES == 2
    if name in ("zero_ticks", "one_tick"):
        assert rt.controller_dispatches == 0


def test_belief_off_uncertainty_reproduces_legacy_bitwise():
    """tests/test_adaptive.py:222 in the port: use_belief=True alone is
    passive bookkeeping, bitwise the legacy report."""
    reps = []
    for kw in (CTL, dict(CTL, use_belief=True)):
        eng = _engine(PORT, 0)
        trace = _outage(PORT, int(np.asarray(eng.fleet.region)[0]))
        reps.append(_run(PORT, eng, trace, np.random.default_rng(1),
                         TA.AdaptiveConfig(**kw)))
    a, b = reps
    assert a.reconfig_ticks == b.reconfig_ticks
    assert a.refit_ticks == b.refit_ticks
    assert a.controller_dispatches == b.controller_dispatches
    assert a.final_com_scale == b.final_com_scale
    for f in ("f_adaptive", "f_static", "f_oracle", "reconfig_costs",
              "drift"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)


# -- the cold start of tests/test_adaptive.py:285 ------------------------------

def _snapshot(m, fleet):
    return m.ExplicitFleet(
        com_cost=np.asarray(fleet.com_matrix(), dtype=np.float64).copy(),
        speed=np.asarray(fleet.effective_speed(), dtype=np.float64).copy(),
        region=np.asarray(fleet.region).copy())


def _slow_tier_trace(m, fleet, factor, n_ticks):
    pct = m.belief.speed_percentile(np.asarray(fleet.effective_speed()))
    return [m.scen.TraceEvent(t=0, kind="degrade", rate=0.0, device=int(u),
                              factor=factor)
            for u in np.flatnonzero(pct < 1.0 / 3.0)] + _ticks(m, 0, n_ticks)


def _slow_tier_corpus(m, factor=8.0, seeds=(10, 11, 12)):
    """_train_slow_tier_prior's corpus, harvested in package ``m``."""
    parts = []
    for seed in seeds:
        eng = _engine(m, seed)
        base = _snapshot(m, eng.fleet)
        rep = m.sim.replay_trace(eng, _slow_tier_trace(m, eng.fleet, factor,
                                                       6),
                                 np.random.default_rng(seed))
        window = m.cal.ReplayWindow.from_report(rep, eng.x)
        parts.append(m.sim.training_tuples(eng.graph.meta, base, window))
    return m.sim.merge_tuples(parts)


def _prior(m, corpus):
    kw = dict(device_features=corpus.device_features,
              device_log_degrade=corpus.device_log_degrade,
              device_weights=corpus.device_weights)
    if m is PORT:
        kw["device"] = CPU
    return m.belief.fit_prior(**kw)


def _cold_start(m, prior, n_ticks=32):
    cfg = m.adapt.AdaptiveConfig(**dict(CTL, amortize_ticks=20.0,
                                        use_belief=True,
                                        belief_sampling=True))
    eng = _engine(m, 6)
    trace = _slow_tier_trace(m, eng.fleet, 8.0, n_ticks)
    return _run(m, eng, trace, np.random.default_rng(2), cfg,
                prior=prior), eng


def test_cold_start_makes_the_jax_runs_decisions():
    """Each package fits its own prior on its own harvested tuples (the
    coefficients differ in the last float32 digits) and runs the
    cold-start belief controller: the same decisions."""
    (rj, ej), (rt, et) = (_cold_start(m, _prior(m, _slow_tier_corpus(m)))
                          for m in (JAX, PORT))
    assert rj.controller_dispatches >= 1
    for f in ("reconfig_ticks", "refit_ticks", "n_refits", "n_reconfigs",
              "controller_dispatches"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert np.array_equal(et.x, ej.x)


def test_cold_start_with_the_jax_prior_is_bitwise():
    """The JAX prior's weights handed to the port: the belief layer and the
    controller then run the same float64 numpy — every series bitwise."""
    pj = _prior(JAX, _slow_tier_corpus(JAX))
    pt = TB.LearnedPrior(**{f.name: getattr(pj, f.name)
                            for f in dataclasses.fields(pj)})
    (rj, ej), (rt, et) = _cold_start(JAX, pj), _cold_start(PORT, pt)
    _same_decisions(rj, rt, ej, et)
    for f in ("f_static", "f_adaptive", "f_oracle", "reconfig_costs"):
        assert np.array_equal(getattr(rt, f), getattr(rj, f)), f


# -- the port's own contracts ---------------------------------------------------

def test_run_adaptive_defaults_to_the_card(monkeypatch):
    """No device means the card: without CUDA the controller raises instead
    of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = _engine(PORT, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.run_adaptive(eng, _ticks(PORT, 0, 2), np.random.default_rng(0),
                        TA.AdaptiveConfig(**CTL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TA.AdaptiveController(eng, TA.AdaptiveConfig(**CTL))


def test_evaluator_is_rebuilt_only_when_the_believed_graph_changes(
        monkeypatch):
    """One evaluator for the run; a new one only after a material
    selectivity re-fit (the drifting world's selectivity drift)."""
    from repro_torch.sim import batched

    built = []
    init = batched.BatchedEvaluator.__init__

    def counting(self, graph, *a, **kw):
        built.append(graph)
        init(self, graph, *a, **kw)

    monkeypatch.setattr(batched.BatchedEvaluator, "__init__", counting)
    eng, trace, seed, kw = _fixture("drifting1", PORT)
    ctl = TA.AdaptiveController(eng, TA.AdaptiveConfig(**kw), device=CPU)
    graphs = []
    reopt = ctl._reoptimize

    def spy(rng):
        graphs.append(ctl.believed_graph)
        return reopt(rng)

    ctl._reoptimize = spy
    rep = ctl.run(trace, np.random.default_rng(seed))
    assert rep.controller_dispatches == len(graphs) > 0
    distinct = [g for k, g in enumerate(graphs) if k == 0 or g is not
                graphs[k - 1]]
    want = len(distinct) - (distinct[0] is eng.graph.meta)
    assert len(built) == 1 + want


def test_region_outage_is_bitwise_degrading_each_device():
    """The engine degrades a whole region in one pass: the fleet and speeds
    equal degrading its devices one by one (the reference's loop)."""
    eng = _engine(PORT, 4)
    ref = _engine(PORT, 4)
    region = int(np.asarray(eng.fleet.region)[-1])
    eng.apply_event("outage", region, factor=16.0, reoptimize=False)
    for u in np.flatnonzero(np.asarray(ref.fleet.region) == region):
        ref.fleet = ref.fleet.degrade_device(int(u), 16.0)
        ref.device_speed[u] /= 16.0
    _same_fleet(eng.fleet, ref.fleet)
    assert np.array_equal(eng.device_speed, ref.device_speed)


# -- chip_smoke.py's phase 13, rehearsed on the CPU ----------------------------

def _chip_smoke():
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke


def _counted_k1(monkeypatch):
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import edge_latency as kernels

    def run(*args):
        kernels.launches["edge_latency_dense"] += 1
        return ref.edge_latency_dense_plain(*args)

    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    monkeypatch.setattr(kernels, "edge_latency_dense", run)
    monkeypatch.setitem(kernels.launches, "edge_latency_dense", 0)


def test_chip_smoke_adaptive_phase_rehearses_on_the_cpu(monkeypatch,
                                                        capsys):
    """chip_smoke.py's phase 13 at 8 regions × 3 devices, K1 swapped for a
    counted plain version: the launches per dispatch, the grid cells
    against the oracle, the simplex and the CPU-route decisions."""
    chip_smoke = _chip_smoke()
    _counted_k1(monkeypatch)
    out = chip_smoke.adaptive_dense_phase(torch, np, torch.device(CPU), 3,
                                          12, profile=False)
    rep = out["rep"]
    assert out["launches"] == 4 * rep.controller_dispatches > 0
    assert rep.reconfig_ticks == out["cpu"].reconfig_ticks
    assert "adaptive_dense: " in capsys.readouterr().out


@pytest.mark.parametrize("reading", ["kernel_device_ms",
                                     "profiled_reoptimize"])
def test_chip_smoke_retakes_profiler_readings_that_lost_events(
        monkeypatch, reading):
    """The card's profiler now and then drops a session's device events:
    a reading that holds fewer launches than it must is taken again, and
    one that never does fails instead of reporting a short time."""
    chip_smoke = _chip_smoke()
    readings = []

    def lossy(torch_, fn):
        fn()
        readings.append(1)
        full = len(readings) == 2              # the first reading lost all
        count = {"kernel_device_ms": 20, "profiled_reoptimize": 4}[reading]
        return 1.0, {"void edge_latency_dense_kernel<true>(float)":
                     [0.4 * count, count if full else 0],
                     "rmsnorm_rows_kernel<4>": [2.0, count if full else 1]}

    monkeypatch.setattr(chip_smoke, "device_events", lossy)
    if reading == "kernel_device_ms":
        assert chip_smoke.kernel_device_ms(torch, lambda: None, 20,
                                           "rmsnorm") == 0.1
        monkeypatch.setattr(chip_smoke, "device_events",
                            lambda torch_, fn: (fn(), (1.0, {}))[1])
        with pytest.raises(AssertionError, match="fewer than 20 rmsnorm"):
            chip_smoke.kernel_device_ms(torch, lambda: None, 20, "rmsnorm")
    else:
        eng, _ = chip_smoke.adaptive_world(np, 3, 2, 1)
        ctl = TA.AdaptiveController(eng, TA.AdaptiveConfig(
            **chip_smoke.CONTROLLER), device=CPU)
        text = chip_smoke.profiled_reoptimize(torch, np, ctl)
        assert text.startswith("(reading 2) ") and "K1 1.6 ms x4" in text
    assert len(readings) == 2
