"""The port's streaming slice against the JAX package: the LM-scoring
operator, the data-quality scores, and the example job
(``examples/geo_placement.py``: ingest → clean → dq_check → lm_score →
window_mean on a 3-region, 12-device fleet, uniform placement) run through
both engines on the same fleet, parameters and batches, with the smoke OLMo
and the smoke Mamba2 as the LM.

Also trace replay (``sim/replay.py``) and the engines' re-optimization
(``greedy_transfer`` on the compute-extension problem) on both packages.

Bars: LM scores ≤1e-5 relative (max |err| / max |want|; float32
activations, the two forwards sum in different orders); everything the
engines compute in numpy — row counts, modeled / true / per-edge latencies
on the float64 cost model, work-model busy times, re-optimized placements
and replay reports — equal bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import ExplicitFleet as JaxFleet  # noqa: E402
from repro.core import uniform_placement as jax_uniform  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.streaming import engine as jax_engine  # noqa: E402
from repro.streaming import operators as jax_ops  # noqa: E402
from repro.streaming.quality import quality_scores as jax_quality  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.devices import ExplicitFleet  # noqa: E402
from repro_torch.core.placement import uniform_placement  # noqa: E402
from repro_torch.streaming import operators as port_ops  # noqa: E402
from repro_torch.streaming import (StreamGraph, StreamingEngine,  # noqa: E402
                                   dq_latency_model, filter_op, map_op,
                                   model_op, quality_op, quality_scores,
                                   source, window_agg)

REL = 1e-5
COM = np.array([[0.0, 1.0, 2.0],
                [1.0, 0.0, 1.5],
                [2.0, 1.5, 0.0]])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _example_fleet():
    """The example's 3 regions × 4 devices with WAN costs and fast region 0
    (examples/geo_placement.py:27-37)."""
    rng = np.random.default_rng(0)
    n_dev, n_regions = 12, 3
    region = np.repeat(np.arange(n_regions), n_dev // n_regions)
    wan = np.array([[0.02, 1.5, 2.5], [1.5, 0.02, 1.0], [2.5, 1.0, 0.02]])
    com = wan[np.ix_(region, region)] + rng.uniform(0, 0.05, (n_dev, n_dev))
    com = (com + com.T) / 2
    np.fill_diagonal(com, 0.0)
    speed = np.where(region == 0, 2.0, 1.0)
    return com, speed, region


def _models(arch="olmo_1b"):
    jcfg = jax_smoke(arch)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    if arch == "olmo_1b":
        cfg = get_smoke_config(arch).replace(attention_impl="pallas")
        model = convert.decoder_lm_from_arrays(cfg, tree, device="cpu")
    else:
        model = convert.mamba2_lm_from_arrays(get_smoke_config(arch), tree,
                                              device="cpu")
    return jcfg, jmodel, params, model


def _capture(op, sink):
    """Record each shard's output of ``op``."""
    fn = op.fn

    def wrapped(rows):
        out = fn(rows)
        sink.append(out)
        return out

    op.fn = wrapped
    return op


def _jobs(arch="olmo_1b"):
    jcfg, jmodel, params, model = _models(arch)
    vocab = jcfg.vocab
    scores = {"jax": [], "port": []}

    def ops(mod, lm, key):
        return [mod.source("ingest"),
                mod.map_op("clean", lambda r: np.clip(r, 0, vocab - 1),
                           work=0.5),
                mod.quality_op("dq_check", threshold=0.4, work=2.0),
                _capture(lm, scores[key]),
                mod.window_agg("window_mean", window=8, work=0.5)]

    edges = [(0, 1), (1, 2), (2, 3), (3, 4)]
    jg = jax_ops.StreamGraph(
        ops(jax_ops, jax_ops.model_op("lm_score", jmodel, params, jcfg,
                                      work=50.0), "jax"), edges)
    g = StreamGraph(ops(port_ops, model_op("lm_score", model, work=50.0),
                        "port"), edges)
    com, speed, region = _example_fleet()
    jfleet = JaxFleet(com_cost=com, speed=speed, region=region)
    fleet = ExplicitFleet(com_cost=com, speed=speed, region=region)
    jx = jax_uniform(5, jfleet.availability(5))
    x = uniform_placement(5, fleet.availability(5))
    assert np.array_equal(jx, x)
    jeng = jax_engine.StreamingEngine(jg, jfleet, jx, alpha=0.002,
                                      device_speed=speed, observed="work")
    eng = StreamingEngine(g, fleet, x, alpha=0.002, device_speed=speed,
                          observed="work")
    return jeng, eng, scores, vocab


def _same_report(rep, jrep):
    assert rep.rows_in == jrep.rows_in and rep.rows_out == jrep.rows_out
    for f in ("modeled_latency", "true_latency", "edge_latencies",
              "device_busy", "op_rows_in", "op_rows_out"):
        assert np.array_equal(getattr(rep, f), getattr(jrep, f)), f


def test_example_job_matches_jax_engine():
    jeng, eng, scores, vocab = _jobs()
    rng = np.random.default_rng(1)
    events = [None, ("degrade", 5, 10.0), ("outage", 1, 3.0),
              ("recover", 1, 3.0), ("drift", 2, 0.8), ("remove", 11, 1.0)]
    for event in events:
        if event is not None:
            kind, dev, factor = event
            jeng.apply_event(kind, dev, factor, reoptimize=False)
            eng.apply_event(kind, dev, factor, reoptimize=False)
            assert np.array_equal(eng.x, jeng.x)
            assert np.array_equal(eng.fleet.com_matrix(),
                                  jeng.fleet.com_matrix())
        batch = rng.integers(0, vocab, (64, 32)).astype(float)
        batch[rng.random(64) < 0.05] = -1  # sensor dropouts
        _same_report(eng.run_batch(batch), jeng.run_batch(batch))
    assert eng.fleet.n_devices == 11 and eng.x.shape == (5, 11)
    assert np.array_equal(eng.true_graph().operators[2].selectivity,
                          jeng.true_graph().operators[2].selectivity)
    got = np.concatenate(scores["port"])
    want = np.concatenate(scores["jax"])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == 1 and len(got) >= 6 * 40
    assert _rel(got, want) <= REL


def test_mamba2_example_job_matches_jax_engine():
    """The example's job with the smoke Mamba2 as the LM: row counts and
    every numpy-side latency bitwise, scores within 1e-5."""
    jeng, eng, scores, vocab = _jobs("mamba2_1_3b")
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = rng.integers(0, vocab, (64, 20)).astype(float)
        batch[rng.random(64) < 0.05] = -1  # sensor dropouts
        _same_report(eng.run_batch(batch), jeng.run_batch(batch))
    got = np.concatenate(scores["port"])
    want = np.concatenate(scores["jax"])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == 1 and len(got) >= 3 * 40
    assert _rel(got, want) <= REL


def test_mamba2_model_op_scores_match_jax():
    jcfg, jmodel, params, model = _models("mamba2_1_3b")
    rows = np.random.default_rng(5).integers(-3, jcfg.vocab + 5,
                                             (5, 20)).astype(float)
    got = model_op("lm", model).fn(rows)
    want = jax_ops.model_op("lm", jmodel, params, jcfg).fn(rows)
    assert got.dtype == np.float32 and got.shape == (5, 1)
    assert _rel(got, want) <= REL


def test_model_op_scores_match_jax():
    jcfg, jmodel, params, model = _models()
    rows = np.random.default_rng(2).integers(-3, jcfg.vocab + 5,
                                             (5, 24)).astype(float)
    got = model_op("lm", model).fn(rows)
    want = jax_ops.model_op("lm", jmodel, params, jcfg).fn(rows)
    assert got.dtype == np.float32 and got.shape == (5, 1)
    assert _rel(got, want) <= REL
    # the model op's metadata matches the reference's
    assert dataclasses.astuple(model_op("lm", model).to_meta()) == \
        dataclasses.astuple(jax_ops.model_op("lm", jmodel, params,
                                             jcfg).to_meta())


def test_quality_scores_equal_the_reference():
    rng = np.random.default_rng(4)
    for trial in range(6):
        toks = rng.integers(-1, 30, (int(rng.integers(2, 20)),
                                     int(rng.integers(4, 40))))
        if trial == 1:
            toks[0] = 7
        if trial == 2:
            toks[1] = -1
        assert np.array_equal(quality_scores(toks), jax_quality(toks))
    assert dq_latency_model(2.0, 0.5, 1.5) == 2.0 / (1.0 + 1.5 * 0.5)


def _pipeline():
    ops = [
        source(),
        map_op("normalize", lambda r: (r - r.mean()) / (r.std() + 1e-9),
               work=1.0),
        filter_op("threshold", lambda r: r[:, 0] > -0.5, selectivity=0.7),
        window_agg("window_mean", window=4),
    ]
    return StreamGraph(ops, [(0, 1), (1, 2), (2, 3)])


def test_engine_runs_and_respects_selectivity():
    g = _pipeline()
    x = uniform_placement(g.meta.n_ops, np.ones((g.meta.n_ops, 3), bool))
    eng = StreamingEngine(g, ExplicitFleet(com_cost=COM), x)
    rep = eng.run_batch(np.random.default_rng(0).normal(size=(256, 4)))
    assert rep.rows_in == 256
    # filter keeps ~70% (here: >−0.5 of standard normal ≈ 69%), window /4
    assert 20 < rep.rows_out["window_mean"] < 64
    assert rep.modeled_latency > 0.0
    assert rep.edge_latencies.shape == (3,)


def test_quality_operator_drops_bad_rows():
    g = StreamGraph([source(), quality_op(threshold=0.5)], [(0, 1)])
    x = uniform_placement(2, np.ones((2, 3), bool))
    eng = StreamingEngine(g, ExplicitFleet(com_cost=COM), x)
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 50, (64, 32)).astype(float)
    batch[:16] = -1  # fully-missing rows → low completeness
    assert eng.run_batch(batch).rows_out["dq_check"] <= 48


def _pipelines():
    """_pipeline() in both packages: (JAX StreamGraph, port StreamGraph)."""
    out = []
    for mod in (jax_ops, port_ops):
        ops = [
            mod.source(),
            mod.map_op("normalize",
                       lambda r: (r - r.mean()) / (r.std() + 1e-9), work=1.0),
            mod.filter_op("threshold", lambda r: r[:, 0] > -0.5,
                          selectivity=0.7),
            mod.window_agg("window_mean", window=4),
        ]
        out.append(mod.StreamGraph(ops, [(0, 1), (1, 2), (2, 3)]))
    return out


def _engine_pair(com=COM, region=(0, 0, 1), beta_graphs=None):
    jg, g = beta_graphs or _pipelines()
    n = g.meta.n_ops
    x = uniform_placement(n, np.ones((n, com.shape[0]), bool))
    region = np.asarray(region)
    jeng = jax_engine.StreamingEngine(
        jg, JaxFleet(com_cost=com, region=region), x, observed="work")
    eng = StreamingEngine(g, ExplicitFleet(com_cost=com, region=region), x,
                          observed="work")
    return jeng, eng


def _same_state(eng, jeng):
    assert np.array_equal(eng.x, jeng.x)
    assert np.array_equal(eng.fleet.com_matrix(), jeng.fleet.com_matrix())
    assert np.array_equal(eng.device_speed, jeng.device_speed)
    assert np.array_equal(eng.fleet.effective_speed(),
                          jeng.fleet.effective_speed())


def test_reoptimize_is_refused_before_any_state_changes():
    """Re-optimization is no longer refused (the name is kept from the
    slice that refused it): every fleet hook re-optimizes by default
    (greedy_transfer on the compute-extension problem, the scalar float64
    loop on both sides) and the re-optimized x equals the JAX engine's
    bitwise; reoptimize=False only mutates the fleet/speed state (and
    remaps x on a removal)."""
    calls = [lambda e: e.degrade_and_replace(2, 10.0, beta=0.5),
             lambda e: e.remove_device(1, beta=1.0),
             lambda e: e.apply_event("outage", 0, 4.0),
             lambda e: e.apply_event("degrade", 1, 2.0, reoptimize=True),
             lambda e: e.apply_event("recover", 0, 4.0, beta=0.3)]
    for call in calls:
        jeng, eng = _engine_pair()
        x0 = eng.x.copy()
        got, want = call(eng), call(jeng)
        _same_state(eng, jeng)
        assert got.F == want.F and got.evals == want.evals
        assert got.dispatches == want.dispatches == 0
        assert np.array_equal(got.x, eng.x) and not np.array_equal(eng.x, x0)
        np.testing.assert_allclose(eng.x.sum(axis=1), 1.0, atol=1e-9)
    jeng, eng = _engine_pair()
    x0 = eng.x.copy()
    for e in (eng, jeng):
        assert e.degrade_and_replace(2, 10.0, reoptimize=False) is None
        assert e.apply_event("outage", 1, 3.0, reoptimize=False) is None
    _same_state(eng, jeng)
    assert np.array_equal(eng.x, x0)
    assert eng.device_speed[2] == 1.0 / 10.0 / 3.0 and \
        eng.fleet.n_devices == 3
    for e in (eng, jeng):
        assert e.remove_device(1, reoptimize=False) is None
    _same_state(eng, jeng)
    assert eng.fleet.n_devices == 2
    np.testing.assert_allclose(eng.x.sum(axis=1), 1.0, atol=1e-6)


def _example_job_without_lm():
    """examples/geo_placement.py's job with the LM-scoring operator left
    out, its 12-device fleet and its placement problem, in both packages.
    Each package gets its own speed array, used as the example uses it:
    as the fleet's speed and the engine's device_speed (the engine divides
    it in place on a degrade, so the two packages must not share it)."""
    from repro.core import CostConfig as JCost
    from repro.core import DQCoupling as JDQ
    from repro.core import PlacementProblem as JProb
    from repro_torch.core import CostConfig, DQCoupling, PlacementProblem
    com, speed, region = _example_fleet()
    out = []
    speeds = []
    for mod, Fleet, Prob, Cost, DQ in (
            (jax_ops, JaxFleet, JProb, JCost, JDQ),
            (port_ops, ExplicitFleet, PlacementProblem, CostConfig,
             DQCoupling)):
        ops = [mod.source("ingest"),
               mod.map_op("clean", lambda r: np.clip(r, 0, 99), work=0.5),
               mod.quality_op("dq_check", threshold=0.4, work=2.0),
               mod.window_agg("window_mean", window=8, work=0.5)]
        g = mod.StreamGraph(ops, [(0, 1), (1, 2), (2, 3)])
        speeds.append(speed.copy())
        fleet = Fleet(com_cost=com, speed=speeds[-1], region=region)
        prob = Prob(g.meta, fleet, Cost(alpha=0.002, include_compute=True),
                    beta=1.0, dq=DQ(cap0=np.full(12, 1.0),
                                    load=np.full(12, 0.05)))
        out.append((g, fleet, prob))
    return out, speeds


def test_example_reoptimization_matches_jax_engine():
    """The example's straggler and elastic steps (greedy placement, device
    5 degraded 10×, device 11 lost, one batch) through both engines:
    placements and reports bitwise, the straggler's mass not risen."""
    from repro.core import greedy_transfer as jax_greedy
    from repro_torch.core import greedy_transfer
    ((jg, jfleet, jprob), (g, fleet, prob)), (jspeed, speed) = \
        _example_job_without_lm()
    jres, res = jax_greedy(jprob), greedy_transfer(prob)
    assert np.array_equal(res.x, jres.x) and res.F == jres.F
    assert res.dispatches == 0
    jeng = jax_engine.StreamingEngine(jg, jfleet, jres.x, alpha=0.002,
                                      device_speed=jspeed, observed="work")
    eng = StreamingEngine(g, fleet, res.x, alpha=0.002, device_speed=speed,
                          observed="work")
    before = eng.x[:, 5].sum()
    got, want = (eng.degrade_and_replace(5, 10.0, beta=1.0),
                 jeng.degrade_and_replace(5, 10.0, beta=1.0))
    assert np.array_equal(got.x, want.x) and got.F == want.F
    assert eng.x[:, 5].sum() <= before + 1e-12
    got, want = eng.remove_device(11, beta=1.0), \
        jeng.remove_device(11, beta=1.0)
    assert np.array_equal(got.x, want.x) and got.F == want.F
    _same_state(eng, jeng)
    rng = np.random.default_rng(2)
    batch = rng.integers(0, 100, (256, 32)).astype(float)
    batch[rng.random(256) < 0.05] = -1
    _same_report(eng.run_batch(batch), jeng.run_batch(batch))
    np.testing.assert_allclose(eng.x.sum(axis=1), 1.0, atol=1e-9)


def _same_replay(rep, jrep):
    assert (rep.scenario, rep.n_degrades, rep.n_removes, rep.n_outages,
            rep.n_drifts) == (jrep.scenario, jrep.n_degrades,
                              jrep.n_removes, jrep.n_outages, jrep.n_drifts)
    assert len(rep.steps) == len(jrep.steps)
    for a, b in zip(rep.steps, jrep.steps):
        assert (a.t, a.kind, a.rate, a.rows_in, a.modeled_latency,
                a.observed_busy, a.n_devices) == \
            (b.t, b.kind, b.rate, b.rows_in, b.modeled_latency,
             b.observed_busy, b.n_devices)
        assert np.array_equal(a.device_busy, b.device_busy)
    assert np.array_equal(rep.busy_series(), jrep.busy_series())
    assert rep.drift() == jrep.drift()


@pytest.mark.parametrize("reoptimize_seed,realism", [(0, False), (3, True),
                                                     (11, True)])
def test_replay_trace_matches_jax_engine(reoptimize_seed, realism):
    """A random_trace with degrade and loss events (and, with realism,
    region outages and selectivity drift) replayed through both engines:
    equal ReplayReport series, equal final placement and fleet (every fleet
    event re-optimizes, as replay_trace asks)."""
    from repro.sim import replay as jax_replay
    from repro.sim import scenarios as jax_scen
    from repro_torch.sim import replay, scenarios
    kw = dict(trace_len=16, base_rate=32.0, degrade_prob=0.2,
              loss_prob=0.1)
    if realism:
        kw.update(outage_on_prob=0.15, selectivity_drift_std=0.2)
    com, _, region = _example_fleet()
    com, region = com[:6, :6], region[:6] // 2
    traces = [mod.random_trace(np.random.default_rng(reoptimize_seed), 6,
                               mod.ScenarioConfig(**kw), n_regions=2,
                               n_ops=4) for mod in (jax_scen, scenarios)]
    kinds = {e.kind for e in traces[1]}
    assert {"degrade", "remove"} & kinds
    jeng, eng = _engine_pair(com, region)
    jrep = jax_replay.replay_trace(jeng, traces[0], np.random.default_rng(1),
                                   beta=0.5, name="t")
    rep = replay.replay_trace(eng, traces[1], np.random.default_rng(1),
                              beta=0.5, name="t")
    _same_replay(rep, jrep)
    _same_state(eng, jeng)


def test_apply_fleet_event_matches_jax_and_keeps_the_removal_floor():
    """apply_fleet_event in the controller's mode (reoptimize=False) and
    the engine's own (True): the same kinds applied or dropped (a dead
    device, the MIN_ALIVE_DEVICES floor) and the same state."""
    from repro.sim import replay as jax_replay
    from repro_torch.sim import TraceEvent, replay
    from repro_torch.sim import MIN_ALIVE_DEVICES
    events = [("degrade", 0, 4.0), ("remove", 1, 1.0), ("remove", 1, 1.0),
              ("outage", 1, 8.0), ("drift", 2, 1.5), ("recover", 1, 8.0),
              ("remove", 2, 1.0), ("degrade", 1, 2.0)]
    for reopt in (False, True):
        jeng, eng = _engine_pair(COM, (0, 0, 1))
        jalive, alive = [0, 1, 2], [0, 1, 2]
        for kind, dev, factor in events:
            ev = TraceEvent(t=0, kind=kind, rate=0.0, device=dev,
                            factor=factor)
            got = replay.apply_fleet_event(eng, ev, alive, beta=0.4,
                                           reoptimize=reopt)
            want = jax_replay.apply_fleet_event(jeng, ev, jalive, beta=0.4,
                                                reoptimize=reopt)
            assert got == want and alive == jalive
            _same_state(eng, jeng)
        assert len(alive) == MIN_ALIVE_DEVICES == eng.fleet.n_devices
        assert np.array_equal(eng.sel_scale, jeng.sel_scale)
    with pytest.raises(ValueError, match="unknown trace event"):
        replay.apply_fleet_event(eng, TraceEvent(t=0, kind="comet",
                                                 rate=1.0), alive)


def test_chip_smoke_lm_score_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's lm_score phase at the smoke config on the CPU, with
    K5 swapped for its plain version behind a counting wrapper: the phase's
    launch, row and reference checks pass and it reports every batch."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import flash_attention as fa

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))

    def counted_plain(q, k, v, causal=True):
        fa.launches["flash_attention"] += 1
        return ref.flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.setattr(dispatch, "plan_attention_kernel", lambda *t: "cuda")
    monkeypatch.setattr(fa, "flash_attention", counted_plain)
    monkeypatch.setitem(fa.launches, "flash_attention", 0)
    cfg = get_smoke_config("olmo_1b").replace(attention_impl="pallas",
                                              act_dtype="bfloat16")
    out = chip_smoke.lm_score_phase(torch, np, torch.device("cpu"), cfg,
                                    rows=48, seq=24, batches=2,
                                    profile=False)
    assert out["calls"] >= 24 and out["shard_rows"] <= 4
    assert out["launches"] == cfg.n_layers * out["calls"]
    assert out["ref_rel"] <= chip_smoke.LM_REF_REL
    printed = capsys.readouterr().out
    assert "lm_score batch 1" in printed and "not measured" in printed


def test_chip_smoke_lm_score_mamba2_phase_rehearses_on_the_cpu(monkeypatch,
                                                               capsys):
    """chip_smoke.py's lm_score_mamba2 phase at the smoke config (bf16
    activations) on the CPU, with K6 and K7 swapped for their plain
    versions behind counting wrappers: K6 once per layer and K7 2·layers+1
    times in every shard call, the row and plain-route checks pass, and
    the swap of the plain-route check is undone after it."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))

    def counted_ssd(*args):
        sk.launches["ssd_scan"] += 1
        return ref.ssd_scan_plain(*args)

    def counted_rms(x, w, eps=1e-6):
        rk.launches["rmsnorm"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    plan = dispatch._plan
    monkeypatch.setattr(dispatch, "_plan", lambda kind, what, t: "cuda"
                        if kind in ("ssd_scan", "rmsnorm")
                        else plan(kind, what, t))
    monkeypatch.setattr(sk, "ssd_scan", counted_ssd)
    monkeypatch.setattr(rk, "rmsnorm", counted_rms)
    monkeypatch.setitem(sk.launches, "ssd_scan", 0)
    monkeypatch.setitem(rk.launches, "rmsnorm", 0)
    cfg = get_smoke_config("mamba2_1_3b").replace(act_dtype="bfloat16")
    out = chip_smoke.lm_score_phase(torch, np, torch.device("cpu"), cfg,
                                    rows=48, seq=20, batches=2,
                                    profile=False)
    assert out["calls"] >= 24 and out["shard_rows"] <= 4
    assert out["launches"] == cfg.n_layers * out["calls"]
    assert out["kernel_launches"] == {
        "ssd_scan": cfg.n_layers * out["calls"],
        "rmsnorm": (2 * cfg.n_layers + 1) * out["calls"]}
    assert out["ref_rel"] <= chip_smoke.LM_REF_REL
    assert sk.ssd_scan is counted_ssd and rk.rmsnorm is counted_rms
    printed = capsys.readouterr().out
    assert "lm_score_mamba2 batch 1" in printed and "not measured" in printed
