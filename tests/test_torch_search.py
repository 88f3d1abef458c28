"""The port's search slice against the JAX package: ``BatchedProblem``,
the four discrete searchers, the ``core.optimizers`` / ``sim.replay``
shims, and the min–max robust searches, on the same problems and seeds.

Bars:

* ``BatchedProblem`` scores ≤1e-5 relative to the JAX engine's (max |err|
  / max |want| over the finite cells; float32 on both sides, summed in
  different orders), the +inf masks equal, and ≤1e-5 relative to the
  float64 ``prob.score`` of every cell;
* the searchers' decisions equal the JAX searchers' — the same ``x`` and
  ``dq_fraction`` bitwise, ``F`` within 1e-12 relative (both re-score the
  winner through their float64 oracle), equal ``evals`` and
  ``dispatches`` — on the seeds of ``tests/test_search_parity.py`` and
  ``tests/test_optimizers.py``;
* robust search: grids ≤1e-5 relative, the same winner.

The port runs on the CPU here (``device="cpu"``: the kernels' plain
versions); the JAX package runs as its own tests run it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.search as JS  # noqa: E402
import repro.sim as JSim  # noqa: E402
import repro.streaming.operators as jax_ops  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.search as TS  # noqa: E402
import repro_torch.sim as TSim  # noqa: E402
import repro_torch.streaming.operators as port_ops  # noqa: E402
from repro_torch.core.optimizers import OptResult, _dq_grid  # noqa: E402
from repro_torch.core.placement import (random_placement,  # noqa: E402
                                        uniform_placement)

CPU = "cpu"
REL = 1e-5
COM = np.array([[0.0, 1.5, 2.0],
                [1.5, 0.0, 1.0],
                [2.0, 1.0, 0.0]])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the problems of the reference tests, built in either package --------------

def _paper(m, beta=1.0, coupling=True):
    """tests/test_optimizers.py's paper_problem (and test_search_parity's
    _problem)."""
    dq = m.DQCoupling(cap0=np.full(3, 1.2), load=np.full(3, 0.2)) \
        if coupling else None
    return m.PlacementProblem(m.linear_graph([1.0, 1.5, 1.0]),
                              m.ExplicitFleet(com_cost=COM), beta=beta, dq=dq)


def _free(m):
    return _paper(m, beta=0.0, coupling=False)


def _pinned(m):
    """test_dq_pinned_to_one_when_free: β 2, an availability mask."""
    fleet = m.ExplicitFleet(com_cost=COM, available=np.array(
        [[1, 1, 0], [0, 1, 1], [1, 0, 1]], dtype=bool))
    return m.PlacementProblem(m.linear_graph([1.0, 1.5, 1.0]), fleet,
                              beta=2.0)


def _diamond(m):
    """test_availability_respected's diamond graph."""
    avail = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 1]],
                     dtype=bool)
    return m.PlacementProblem(m.diamond_graph(),
                              m.ExplicitFleet(com_cost=COM, available=avail))


def _multi(m):
    """test_engine_multi_objective_matches_scalar_total's problem."""
    obj = m.ObjectiveSet.from_weights(latency_f=1.0, network_movement=0.01,
                                      occupancy_max=0.1)
    g = m.linear_graph([1.0, 1.5, 1.0], out_bytes=2.0, work=0.3)
    fleet = m.ExplicitFleet(com_cost=COM, speed=np.array([1.0, 0.5, 2.0]))
    return m.PlacementProblem(g, fleet, beta=0.8, objectives=obj)


def _structured(m, coupling=False):
    """test_engine_structured_fleet_path's degraded RegionFleet."""
    region = np.array([0, 0, 1, 1, 2, 2])
    inter = np.array([[0.1, 2.0, 3.0], [2.0, 0.1, 1.0], [3.0, 1.0, 0.1]])
    fleet = m.RegionFleet(region=region, inter=inter).degrade_device(1, 4.0)
    dq = m.DQCoupling(cap0=np.full(6, 0.9), load=np.full(6, 0.3)) \
        if coupling else None
    return m.PlacementProblem(m.linear_graph([1.0, 0.7, 1.2]), fleet,
                              beta=1.0, dq=dq)


PROBLEMS = {"paper": _paper, "free": _free, "pinned": _pinned,
            "diamond": _diamond, "multi": _multi, "structured": _structured,
            "structured_coupled": lambda m: _structured(m, coupling=True)}


def _pair(name):
    return PROBLEMS[name](J), PROBLEMS[name](T)


# -- BatchedProblem against the JAX engine and the float64 oracle --------------

@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_batched_problem_matches_jax_and_oracle(name):
    pj, pt = _pair(name)
    ej, et = JS.BatchedProblem(pj), TS.BatchedProblem(pt, device=CPU)
    rng = np.random.default_rng(5)
    avail = pt.availability()
    xs = np.stack([random_placement(pt.graph.n_ops, avail, rng, 0.3)
                   for _ in range(37)])
    dqs = np.array([0.0, 0.25, 0.5, 1.0])
    got, want = et.score_batch(xs, dqs), ej.score_batch(xs, dqs)
    assert got.shape == want.shape == (37, 4)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any()
    assert _rel(got[fin], want[fin]) <= REL
    oracle = np.array([[pt.score(x, float(d)) for d in dqs] for x in xs])
    assert np.array_equal(np.isinf(got), np.isinf(oracle))
    assert _rel(got[fin], oracle[fin]) <= REL
    assert np.array_equal(et.feasible_mask(xs, dqs), ej.feasible_mask(xs, dqs))
    # paired (candidate, dq) scoring, as simulated annealing uses it
    dq_pairs = rng.choice(dqs, size=37)
    gp, wp = et.score_pairs(xs, dq_pairs), ej.score_pairs(xs, dq_pairs)
    assert np.array_equal(np.isinf(gp), np.isinf(wp))
    assert _rel(gp[np.isfinite(wp)], wp[np.isfinite(wp)]) <= REL
    # the counters: 37 candidates pad to one 64-row bucket per call
    assert (et.evals, et.dispatches) == (ej.evals, ej.dispatches) == \
        (37 * 4 + 37, 2)


def test_batched_problem_chunks_and_best_match_jax():
    pj, pt = _pair("paper")
    ej = JS.BatchedProblem(pj, chunk=16)
    et = TS.BatchedProblem(pt, chunk=16, device=CPU)
    rng = np.random.default_rng(1)
    xs = np.stack([random_placement(3, pt.availability(), rng)
                   for _ in range(40)])
    dqs = np.array([0.0, 0.6, 1.0])
    assert et.best(xs, dqs)[:2] == ej.best(xs, dqs)[:2]
    assert et.dispatches == ej.dispatches == 3      # 16 + 16 + 8 (→ 8)
    lat_t, rest_t = et.raw_values(xs)
    lat_j, rest_j = ej.raw_values(xs)
    assert _rel(lat_t, lat_j) <= REL and not rest_t.any() and \
        not rest_j.any()


def test_batched_problem_meters_dispatches_and_buckets():
    """The reference's obs counters: dispatches, candidates, and one
    first-dispatch count per padded bucket."""
    from repro_torch import obs
    reg = obs.MetricsRegistry(enabled=True)
    prev = obs.set_registry(reg)
    try:
        et = TS.BatchedProblem(_paper(T), chunk=16, device=CPU)
        xs = np.full((20, 3, 3), 1 / 3)
        et.score_batch(xs, [0.0, 1.0])          # chunks 16 + 4
        et.score_batch(xs[:3], [0.0])           # bucket 4 again
    finally:
        obs.set_registry(prev)
    assert reg.value("search.dispatches") == et.dispatches == 3
    assert reg.value("search.candidates") == 23
    assert reg.value("search.bucket_first_dispatch", bucket="16") == 1
    assert reg.value("search.bucket_first_dispatch", bucket="4") == 1


def test_batched_problem_validates_the_batch():
    from repro_torch.analysis import AnalysisError
    et = TS.BatchedProblem(_paper(T), device=CPU)
    with pytest.raises(AnalysisError, match="does not end in"):
        et.score_batch(np.ones((2, 3, 4)), [0.0])
    with pytest.raises(AnalysisError, match="not real-numeric"):
        et.score_batch(np.array([[["a"] * 3] * 3]), [0.0])
    assert et.dispatches == 0
    from repro_torch.analysis import sanitize
    xs = np.full((2, 3, 3), 1 / 3)
    xs[1, 0, 0] = np.nan
    with sanitize.sanitized():
        with pytest.raises(AnalysisError, match="NaN"):
            et.score_batch(xs, [0.0])
        with pytest.raises(AnalysisError, match="dq-domain"):
            et.score_pairs(xs[:1], [1.5])


def test_batched_problem_keeps_the_fleet_pack_on_its_device(monkeypatch):
    et = TS.BatchedProblem(_paper(T), device=CPU)
    assert isinstance(et._pack, torch.Tensor)
    assert et._pack.shape == (1, 3, 3) and et._pack.dtype == torch.float32
    assert et._pack.device.type == "cpu"
    ev = TSim.BatchedEvaluator(_paper(T).graph, device=CPU)
    assert TS.BatchedProblem(_paper(T), evaluator=ev)._ev is ev
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="evaluator runs on"):
        TS.BatchedProblem(_paper(T), evaluator=ev, device="cuda:0")


def test_scalar_fallback_builds_no_evaluator(monkeypatch):
    """include_compute problems (the StreamingEngine's re-optimize path)
    take the exact scalar loop BEFORE any evaluator or device is resolved:
    no card is needed, no dispatch is issued, and the scores are the
    oracle's."""
    import repro_torch.search.engine as engine_mod

    def refuse(*a, **k):
        raise AssertionError("an evaluator was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine_mod, "BatchedEvaluator", refuse)
    prob = T.PlacementProblem(T.linear_graph([1.0, 1.0, 1.0], work=0.5),
                              T.ExplicitFleet(com_cost=COM),
                              T.CostConfig(include_compute=True))
    eng = TS.BatchedProblem(prob)
    assert eng.scalar_fallback and not hasattr(eng, "_ev")
    xs = uniform_placement(3, prob.availability())[None]
    scores = eng.score_batch(xs, np.array([0.0]))
    assert scores[0, 0] == prob.score(xs[0], 0.0)
    assert eng.dispatches == 0
    res = TS.greedy_transfer(prob)
    assert res.dispatches == 0 and res.F <= prob.score(xs[0], 0.0)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TS.BatchedProblem(_paper(T)),
                 lambda: TS.random_search(_paper(T),
                                          np.random.default_rng(0), 8),
                 lambda: T.greedy_transfer(_paper(T))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- the four searchers against the JAX ones ----------------------------------

def _same_result(got, want):
    assert np.array_equal(got.x, want.x)
    assert got.dq_fraction == want.dq_fraction
    assert got.F == pytest.approx(want.F, rel=1e-12, abs=1e-15)
    assert got.latency == pytest.approx(want.latency, rel=1e-12, abs=1e-15)
    assert (got.evals, got.dispatches) == (want.evals, want.dispatches)
    assert len(got.history) == len(want.history)


SEARCHES = {
    # the seeds and budgets of test_search_parity.py / test_optimizers.py
    "greedy": lambda mod, p, dev: mod.greedy_transfer(p, **dev),
    "sa_0_1500": lambda mod, p, dev: mod.simulated_annealing(
        p, np.random.default_rng(0), steps=1500, **dev),
    "sa_1_800": lambda mod, p, dev: mod.simulated_annealing(
        p, np.random.default_rng(1), steps=800, **dev),
    "rs_42_256": lambda mod, p, dev: mod.random_search(
        p, np.random.default_rng(42), n_candidates=256, **dev),
    "rs_0_512": lambda mod, p, dev: mod.random_search(
        p, np.random.default_rng(0), n_candidates=512, batch=256, **dev),
}


@pytest.mark.parametrize("search", sorted(SEARCHES))
@pytest.mark.parametrize("name", ["paper", "pinned", "diamond", "multi",
                                  "structured", "structured_coupled"])
def test_searcher_decisions_match_jax(name, search):
    pj, pt = _pair(name)
    want = SEARCHES[search](JS, pj, {})
    got = SEARCHES[search](TS, pt, {"device": CPU})
    _same_result(got, want)
    T.validate_placement(got.x, pt.availability())
    assert pt.feasible(got.x, got.dq_fraction)


@pytest.mark.parametrize("name,granularity", [("paper", 3), ("paper", 4),
                                              ("free", 3), ("pinned", 4)])
def test_exhaustive_matches_jax(name, granularity):
    pj, pt = _pair(name)
    _same_result(TS.exhaustive_search(pt, granularity=granularity,
                                      device=CPU),
                 JS.exhaustive_search(pj, granularity=granularity))


def test_degrade_reoptimization_matches_jax():
    """test_degrade_device_shifts_mass: greedy, degrade device 0 by 8×,
    greedy again from the first result."""
    out = {}
    for key, m, dev in (("jax", J, {}), ("port", T, {"device": CPU})):
        g = m.linear_graph([1.0, 1.0, 1.0])
        fleet = m.ExplicitFleet(com_cost=COM)
        dq = m.DQCoupling(cap0=np.full(3, 1.2), load=np.zeros(3))
        res0 = m.greedy_transfer(m.PlacementProblem(g, fleet, dq=dq), **dev)
        prob2 = m.PlacementProblem(g, fleet.degrade_device(0, 8.0), dq=dq)
        out[key] = (res0, m.greedy_transfer(prob2, x0=res0.x, **dev))
    for got, want in zip(out["port"], out["jax"]):
        _same_result(got, want)
    assert out["port"][1].x[:, 0].sum() <= out["port"][0].x[:, 0].sum() + 1e-9


def test_engine_is_reused_across_searches():
    pt = _paper(T)
    eng = TS.BatchedProblem(pt, device=CPU)
    a = TS.random_search(pt, np.random.default_rng(3), n_candidates=64,
                         engine=eng)
    b = TS.greedy_transfer(pt, engine=eng)
    assert eng.dispatches == a.dispatches + b.dispatches
    with pytest.raises(ValueError, match="different PlacementProblem"):
        TS.greedy_transfer(_paper(T), engine=eng)


# -- mirrors of tests/test_search_parity.py's own assertions --------------------

def _scalar_exhaustive(prob, granularity):
    import itertools
    avail = prob.availability()
    n_ops, n_dev = avail.shape

    def comps(total, parts):
        if parts == 1:
            yield (total,)
            return
        for head in range(total + 1):
            for tail in comps(total - head, parts - 1):
                yield (head,) + tail

    per_op = []
    for i in range(n_ops):
        idx = np.flatnonzero(avail[i])
        rows = []
        for comp in comps(granularity, idx.size):
            row = np.zeros(n_dev)
            row[idx] = np.asarray(comp) / granularity
            rows.append(row)
        per_op.append(rows)
    best_F, best_x, best_dq = math.inf, None, 0.0
    for rows in itertools.product(*per_op):
        x = np.stack(rows)
        for dq in _dq_grid(prob):
            f = prob.score(x, dq)
            if f < best_F:
                best_F, best_x, best_dq = f, x, dq
    return OptResult.of(prob, best_x, best_dq, [best_F], 0)


@pytest.mark.parametrize("beta,coupling", [(0.0, False), (1.0, True)])
def test_exhaustive_equals_the_scalar_loop(beta, coupling):
    prob = _paper(T, beta=beta, coupling=coupling)
    want = _scalar_exhaustive(prob, 3)
    got = TS.exhaustive_search(prob, granularity=3, device=CPU)
    assert got.F == pytest.approx(want.F, rel=1e-5)
    assert got.dq_fraction == pytest.approx(want.dq_fraction, abs=1e-9)
    assert got.dispatches >= 1


def test_random_search_equals_the_scalar_loop():
    prob = _paper(T)
    rng = np.random.default_rng(42)
    avail = prob.availability()
    best_F, best_x = math.inf, None
    for x in [uniform_placement(3, avail)] + [
            random_placement(3, avail, rng, 0.5) for _ in range(256)]:
        for dq in _dq_grid(prob):
            f = prob.score(x, dq)
            if f < best_F:
                best_F, best_x = f, x
    got = TS.random_search(prob, np.random.default_rng(42), n_candidates=256,
                           device=CPU)
    assert got.F == pytest.approx(best_F, rel=1e-5)
    np.testing.assert_allclose(got.x, best_x, atol=1e-12)


def test_greedy_is_locally_optimal_and_beats_uniform():
    prob = _paper(T)
    res = TS.greedy_transfer(prob, device=CPU)
    avail = prob.availability()
    for i in range(prob.graph.n_ops):
        for c in TS.transfer_neighborhood(res.x, avail, i, 0.05):
            assert prob.score(c, res.dq_fraction) >= res.F - 1e-9
    assert res.F <= prob.score(uniform_placement(3, avail), 0.0) + 1e-9
    assert prob.feasible(res.x, res.dq_fraction)


def test_dispatch_collapse():
    prob = _paper(T)
    got = TS.random_search(prob, np.random.default_rng(0), n_candidates=512,
                           batch=256, device=CPU)
    assert got.evals >= 512 and got.dispatches <= 4
    ex = TS.exhaustive_search(prob, granularity=4, device=CPU)
    assert ex.evals > 20_000 and ex.dispatches <= 2


def test_annealing_block_search_improves():
    prob = _paper(T)
    res = TS.simulated_annealing(prob, np.random.default_rng(0), steps=1500,
                                 device=CPU)
    base = prob.score(uniform_placement(3, prob.availability()), 0.0)
    assert res.F <= base + 1e-9 and prob.feasible(res.x, res.dq_fraction)
    assert res.dispatches <= math.ceil(1500 / 64) + 1


def test_old_entry_points_are_shims():
    import repro_torch.core.optimizers as co
    import repro_torch.sim.replay as replay

    pj, pt = _pair("paper")
    got = co.random_search(pt, np.random.default_rng(1), n_candidates=64,
                           device=CPU)
    want = J.random_search(pj, np.random.default_rng(1), n_candidates=64)
    _same_result(got, want)
    assert got.dispatches >= 1      # the batched path is underneath
    _same_result(co.greedy_transfer(pt, device=CPU), J.greedy_transfer(pj))
    _same_result(co.exhaustive_search(pt, granularity=3, device=CPU),
                 J.exhaustive_search(pj, granularity=3))
    _same_result(co.simulated_annealing(pt, np.random.default_rng(2),
                                        steps=300, device=CPU),
                 J.simulated_annealing(pj, np.random.default_rng(2),
                                       steps=300))
    assert replay.robust_placement.__module__ == "repro_torch.sim.replay"
    assert co.scenario_robust_search.__module__ == "repro_torch.core.optimizers"


def test_projected_gradient_raises_naming_a9():
    from repro_torch.core.optimizers import projected_gradient
    with pytest.raises(NotImplementedError, match="A9"):
        projected_gradient(_paper(T), steps=10)


# -- robust search against the JAX package ------------------------------------

CFG = dict(trace_len=8, base_rate=32.0, n_regions=(2, 3),
           devices_per_region=(2, 3))


def _families(kind, seed=0, n=4):
    """The same scenario family in both packages: dense (scenario_batch,
    ExplicitFleets) or structured (region_scenario_batch, RegionFleets)."""
    out = []
    for sim, core in ((JSim, J), (TSim, T)):
        rng = np.random.default_rng(seed)
        g = core.random_dag(5, 0.5, np.random.default_rng(9))
        cfg = sim.ScenarioConfig(**CFG)
        if kind == "dense":
            out.append(sim.scenario_batch(rng, n, cfg, graph=g))
        else:
            out.append(sim.region_scenario_batch(rng, n, cfg, graph=g,
                                                 n_devices=24))
    return out


@pytest.mark.parametrize("kind", ["dense", "structured"])
@pytest.mark.parametrize("multi", [False, True])
def test_robust_placement_matches_jax(kind, multi):
    sj, st = _families(kind)
    kw = dict(n_candidates=48, beta=0.7, dq=np.array([0.1, 0.5, 0.0, 1.0]))
    oj = J.ObjectiveSet.from_weights(latency_f=1.0, network_movement=0.01,
                                     occupancy_max=0.1) if multi else None
    ot = T.ObjectiveSet.from_weights(latency_f=1.0, network_movement=0.01,
                                     occupancy_max=0.1) if multi else None
    xj, wj, gj = JSim.robust_placement(sj[0].graph, sj,
                                       np.random.default_rng(3),
                                       objectives=oj, **kw)
    xt, wt, gt = TSim.robust_placement(st[0].graph, st,
                                       np.random.default_rng(3),
                                       objectives=ot, device=CPU, **kw)
    assert _rel(gt, np.asarray(gj)) <= REL
    assert np.array_equal(xt, xj)
    assert wt == pytest.approx(wj, rel=REL)
    assert wt == float(np.asarray(gt, np.float64).max(0).min())


ROBUST_RUNS = {
    "default": dict(n_candidates=32),
    "per_scenario_dq": dict(n_candidates=32, beta=1.0,
                            dq=np.array([0.2, 0.8, 0.0, 0.5])),
    "objectives": dict(n_candidates=32, beta=0.5, objectives="multi"),
    "co_optimize": dict(n_candidates=32, beta=1.0, co_optimize_dq=True,
                        dq=np.array([0.3, 0.3, 0.7, 0.1]), coupling=True),
    "co_optimize_no_warm": dict(n_candidates=32, beta=1.0,
                                co_optimize_dq=True, warm_start=False,
                                coupling=True, objectives="multi"),
}


@pytest.mark.parametrize("run", sorted(ROBUST_RUNS))
@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_scenario_robust_search_matches_jax(kind, run):
    sj, st = _families(kind, seed=2)
    results = []
    for core, scens, dev in ((J, sj, {}), (T, st, {"device": CPU})):
        kw = dict(ROBUST_RUNS[run])
        v = scens[0].n_devices
        if kw.pop("coupling", False):
            kw["dq_coupling"] = core.DQCoupling(cap0=np.full(v, 2.0),
                                                load=np.full(v, 0.5))
        if kw.get("objectives") == "multi":
            kw["objectives"] = core.ObjectiveSet.from_weights(
                latency_f=1.0, network_movement=0.02)
        results.append(core.scenario_robust_search(
            scens[0].graph, scens, np.random.default_rng(4), **kw, **dev))
    want, got = results
    _same_result(got, want)
    assert got.history[0] == pytest.approx(want.history[0], rel=REL)


def test_what_if_search_section_matches_jax():
    """examples/what_if.py's search section at its sizes: 8 worlds of a
    (3-4) × (3-5) family, the robust search over 256 candidates with
    greedy warm starts, then the multi-objective one, on one rng."""
    res = {}
    for key, sim, core, m_ops, dev in (
            ("jax", JSim, J, jax_ops, {}),
            ("port", TSim, T, port_ops, {"device": CPU})):
        rng = np.random.default_rng(0)
        ops = [m_ops.source(),
               m_ops.map_op("normalize",
                            lambda r: (r - r.mean()) / (r.std() + 1e-9)),
               m_ops.filter_op("threshold", lambda r: r[:, 0] > -0.5,
                               selectivity=0.7),
               m_ops.window_agg("window_mean", window=4)]
        sg = m_ops.StreamGraph(ops, [(0, 1), (1, 2), (2, 3)])
        cfg = sim.ScenarioConfig(n_regions=(3, 4), devices_per_region=(3, 5),
                                 trace_len=24, base_rate=128.0,
                                 degrade_prob=0.1, loss_prob=0.05)
        scens = sim.scenario_batch(rng, 8, cfg, graph=sg.meta)
        v = scens[0].n_devices
        # the example's what-if grid draws 256 placements from the same rng
        [random_placement(sg.meta.n_ops, np.ones((sg.meta.n_ops, v), bool),
                          rng, 0.5) for _ in range(256)]
        obj = core.ObjectiveSet.from_weights(latency_f=1.0,
                                             network_movement=0.002,
                                             occupancy_max=0.05)
        res[key] = (core.scenario_robust_search(sg.meta, scens, rng,
                                                n_candidates=256, **dev),
                    core.scenario_robust_search(sg.meta, scens, rng,
                                                n_candidates=256,
                                                objectives=obj, **dev))
    for got, want in zip(res["port"], res["jax"]):
        _same_result(got, want)


def test_dense_fallback_warns_and_refuses_past_its_byte_limit(monkeypatch):
    import repro_torch.search.robust as robust
    g = T.random_dag(4, 0.5, np.random.default_rng(1))
    inter = np.array([[0.1, 1.0], [1.0, 0.1]])
    a = T.RegionFleet(region=np.array([0, 0, 1, 1, 1]), inter=inter)
    b = T.RegionFleet(region=np.array([0, 1, 1, 1, 0]), inter=inter)
    scens = [TSim.Scenario(name=f"s{k}", graph=g, fleet=f, trace=[])
             for k, f in enumerate((a, b))]
    with pytest.warns(RuntimeWarning, match="dense"):
        x, worst, grid = TS.robust_placement(g, scens,
                                             np.random.default_rng(0),
                                             n_candidates=8, device=CPU)
    assert grid.shape == (2, 8) and np.isfinite(grid).all()
    monkeypatch.setattr(robust, "_DENSE_FALLBACK_MAX_BYTES", 100)
    with pytest.raises(ValueError, match="dense fallback would materialize"):
        TS.robust_placement(g, scens, np.random.default_rng(0),
                            n_candidates=8, device=CPU)


# -- chip_smoke.py's search phases, rehearsed on the CPU ------------------------

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


def _counted_plain_kernels(monkeypatch):
    """K1/K2 planned "cuda" and swapped for their plain versions behind
    counting wrappers, as chip_smoke.py's other rehearsals do."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import edge_latency as kernels

    def counted(name, fn):
        def run(*args):
            kernels.launches[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    for name, fn in (("edge_latency_dense", ref.edge_latency_dense_plain),
                     ("edge_latency_structured",
                      ref.edge_latency_structured_plain)):
        monkeypatch.setattr(kernels, name, counted(name, fn))
        monkeypatch.setitem(kernels.launches, name, 0)


@pytest.mark.parametrize("phase", ["search_dense", "search_greedy",
                                   "robust_structured",
                                   "streaming_reoptimize"])
def test_chip_smoke_search_phases_rehearse_on_the_cpu(monkeypatch, capsys,
                                                      phase):
    """chip_smoke.py's phases 9-12 at a small V on the CPU, K1/K2 swapped
    for counted plain versions: every dispatch, launch, plain-version,
    oracle, uniform and coupling check runs."""
    chip_smoke = _chip_smoke()
    _counted_plain_kernels(monkeypatch)
    cpu = torch.device("cpu")
    graph = T.random_dag(chip_smoke.N_OPS, chip_smoke.EDGE_PROB,
                         np.random.default_rng(chip_smoke.SEED))
    assert graph.n_edges == 21
    if phase == "search_dense":
        out = chip_smoke.search_dense_phase(torch, np, cpu, graph, 4, 64, 16,
                                            128, 16, profile=False)
        assert out["launches"] == {"random_search": 5,
                                   "simulated_annealing": 8}
        assert out["sa"].F <= out["rs"].F <= out["uniform_F"] * (1 + 1e-5)
    elif phase == "search_greedy":
        out = chip_smoke.search_greedy_phase(torch, np, cpu, graph, 2)
        assert out["launches"] == out["res"].dispatches > 0
        assert out["same"]
    elif phase == "robust_structured":
        out = chip_smoke.robust_structured_phase(torch, np, cpu, graph, 512,
                                                 chip_smoke.S, 32,
                                                 profile=False)
        assert out["launches"] == chip_smoke.S and out["peak"] is None
        assert out["oracle_rel"] <= chip_smoke.REL
    else:
        out = chip_smoke.streaming_reoptimize_phase(np)
        before, after = out["mass"]
        assert after <= before
    assert f"{phase}: " in capsys.readouterr().out
