"""The port's belief layer against the JAX package: the featurization
(``belief/features.py``), the ridge prior (``belief/prior.py``), the
posterior (``belief/state.py``), the training tuples (``sim/training.py``)
and belief-sampled robust search (``search/robust.py``).

Bars:

* features, state (the generator's state after a draw included) and
  training tuples are bitwise equal to the reference's;
* the prior's coefficients are within 1e-5 relative (max |Δ| / max |w|)
  of the JAX fit on the same tuples — float32 normal equations on both
  sides, formed and solved in different orders — and ``ridge_loss`` within
  1e-6.  Where the float32 system does not determine the coefficients to
  1e-5 (the planted tuples at the default ridge: the JAX fit itself lies
  further than that from the exact minimizer), the test shows it and holds
  the predictions and the loss instead;
* a JAX ``LearnedPrior`` handed to the port gives the same posterior;
* belief-robust search picks the JAX search's winner (the same x and dq).

The port runs on the CPU here (``device="cpu"``); the JAX package runs as
its own tests run it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.belief as JB  # noqa: E402
import repro.core.calibration as JC  # noqa: E402
import repro.core.devices as JD  # noqa: E402
import repro.core.graph as JG  # noqa: E402
import repro.search as JSe  # noqa: E402
import repro.sim as JS  # noqa: E402
import repro_torch.belief as TB  # noqa: E402
import repro_torch.core.calibration as TC  # noqa: E402
import repro_torch.core.devices as TD  # noqa: E402
import repro_torch.core.graph as TG  # noqa: E402
import repro_torch.search as TSe  # noqa: E402
import repro_torch.sim as TS  # noqa: E402

CPU = "cpu"
COEF_REL = 1e-5
LOSS_REL = 1e-6

PKGS = {"jax": (JB, JC, JD, JG, JS, JSe), "port": (TB, TC, TD, TG, TS, TSe)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _equal(a, b):
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


# -- fleets and graphs of tests/test_belief.py, in either package --------------

def _chain_graph(G):
    ops = [G.Operator("source", selectivity=1.0, out_bytes=4.0, work=1.0),
           G.Operator("map", selectivity=1.0, out_bytes=8.0, work=2.0),
           G.Operator("filter", selectivity=0.5, out_bytes=4.0, work=1.0)]
    return G.OpGraph(ops, [(0, 1), (1, 2)])


def _random_fleet(D, rng, v=6):
    com = rng.uniform(0.5, 2.0, (v, v))
    com = (com + com.T) / 2
    np.fill_diagonal(com, 0.0)
    speed = rng.uniform(0.5, 4.0, v)
    return D.ExplicitFleet(com_cost=com, speed=speed,
                           region=np.arange(v) // 2)


def _planted(B, fleet, slow_factor):
    pct = B.speed_percentile(np.asarray(fleet.effective_speed()))
    return np.where(pct < 1.0 / 3.0, slow_factor, 1.0)


def _synthetic_window(C, graph, fleet, d_true, sel_scale_true,
                      work_unit=1e-3, t_ticks=6, rate=64.0):
    """tests/test_belief.py's _synthetic_window in package ``C``."""
    v, n_ops = fleet.n_devices, graph.n_ops
    x = np.full((n_ops, v), 1.0 / v)
    rates = np.full(t_ticks, rate)
    sel_true = np.array([op.selectivity for op in graph.operators]) \
        * sel_scale_true
    rows_in = np.empty((t_ticks, n_ops))
    rows_out = np.empty((t_ticks, n_ops))
    for i in range(n_ops):
        parents = [a for a, b in graph.edges if b == i]
        rows_in[:, i] = rates if not parents \
            else np.sum([rows_out[:, a] for a in parents], axis=0)
        rows_out[:, i] = rows_in[:, i] * sel_true[i]
    wk = np.array([op.work for op in graph.operators])
    load = np.einsum("ti,iu->tu", rows_in * wk[None, :], x)
    speed = np.asarray(fleet.effective_speed(), dtype=np.float64)
    busy = work_unit * load * (d_true / speed)[None, :]
    return C.ReplayWindow(rates=rates, busy=busy,
                          observed_latency=busy.max(axis=1), xs=x,
                          op_rows_in=rows_in, op_rows_out=rows_out)


def _planted_corpus(pkg):
    """The corpus of test_prior_recovers_planted_degrade_and_selectivity."""
    B, C, D, G, S, _ = PKGS[pkg]
    graph = _chain_graph(G)
    parts = []
    for seed in range(6):
        fleet = _random_fleet(D, np.random.default_rng(seed))
        window = _synthetic_window(C, graph, fleet, _planted(B, fleet, 6.0),
                                   np.array([1.0, 1.0, 1.4]))
        parts.append(S.training_tuples(graph, fleet, window, work_unit=1e-3))
    return S.merge_tuples(parts)


def _bench_corpus(pkg):
    """benchmarks/bench_belief.py's _train_prior corpus: replay windows of
    three disjoint training fleets with the slow tier slowed 8×."""
    import repro.core.placement as JP
    import repro.sim.scenarios as JSC
    import repro.streaming.engine as JE
    import repro.streaming.operators as JO
    import repro_torch.core.placement as TP
    import repro_torch.sim.scenarios as TSC
    import repro_torch.streaming.engine as TE
    import repro_torch.streaming.operators as TO

    B, C, D, G, S, _ = PKGS[pkg]
    P, SC, E, O = (JP, JSC, JE, JO) if pkg == "jax" else (TP, TSC, TE, TO)
    parts = []
    for seed in (10, 11, 12):
        rng = np.random.default_rng(seed)
        ops = [O.source(),
               O.map_op("normalize",
                        lambda r: (r - r.mean()) / (r.std() + 1e-9)),
               O.filter_op("threshold", lambda r: r[:, 0] > -0.5,
                           selectivity=0.7)]
        sg = O.StreamGraph(ops, [(0, 1), (1, 2)])
        cfg = S.ScenarioConfig(trace_len=8, base_rate=32.0, n_regions=(3, 3),
                               devices_per_region=(2, 2))
        s = S.scenario_batch(rng, 1, cfg, graph=sg.meta)[0]
        x = P.uniform_placement(sg.meta.n_ops,
                                np.ones((sg.meta.n_ops, s.n_devices), bool))
        eng = E.StreamingEngine(sg, s.fleet, x, observed="work")
        base = D.ExplicitFleet(
            com_cost=np.asarray(eng.fleet.com_matrix()).copy(),
            speed=np.asarray(eng.fleet.effective_speed()).copy(),
            region=np.asarray(eng.fleet.region).copy())
        pct = B.speed_percentile(np.asarray(eng.fleet.effective_speed()))
        trace = [SC.TraceEvent(t=0, kind="degrade", rate=0.0, device=int(u),
                               factor=8.0)
                 for u in np.flatnonzero(pct < 1.0 / 3.0)]
        trace += [SC.TraceEvent(t=k, kind="rate", rate=32.0)
                  for k in range(6)]
        rep = S.replay_trace(eng, trace, np.random.default_rng(seed))
        window = C.ReplayWindow.from_report(rep, eng.x)
        parts.append(S.training_tuples(eng.graph.meta, base, window))
    return S.merge_tuples(parts)


CORPORA = {"planted": _planted_corpus, "bench_belief": _bench_corpus}


# -- features ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("kind", ["explicit", "region", "ties"])
def test_device_features_are_bitwise_the_reference(seed, kind):
    fleets = []
    for D in (JD, TD):
        r = np.random.default_rng(seed)
        if kind == "region":
            region = r.integers(0, 3, 9)
            inter = r.uniform(0.5, 3.0, (3, 3))
            f = D.RegionFleet(region=region, inter=(inter + inter.T) / 2,
                              speed=r.lognormal(0.0, 0.3, 9))
        else:
            f = _random_fleet(D, r, v=8)
            if kind == "ties":
                f = D.ExplicitFleet(com_cost=f.com_cost,
                                    speed=np.round(f.speed),
                                    region=np.zeros(8, dtype=np.int64))
        fleets.append(f)
    speed = np.asarray(fleets[0].effective_speed())
    assert _equal(JB.speed_percentile(speed), TB.speed_percentile(speed))
    assert _equal(JB.device_features(fleets[0]),
                  TB.device_features(fleets[1]))
    assert TB.DEVICE_FEATURES == JB.DEVICE_FEATURES


@pytest.mark.parametrize("seed", [0, 3])
def test_op_features_are_bitwise_the_reference(seed):
    gj = JG.random_dag(7, 0.4, np.random.default_rng(seed))
    gt = TG.random_dag(7, 0.4, np.random.default_rng(seed))
    assert _equal(JB.op_features(gj), TB.op_features(gt))
    assert _equal(JB.op_features(_chain_graph(JG)),
                  TB.op_features(_chain_graph(TG)))
    assert TB.OP_FEATURES == JB.OP_FEATURES


# -- training tuples -----------------------------------------------------------

@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_training_tuples_are_bitwise_the_reference(corpus):
    cj, ct = CORPORA[corpus]("jax"), CORPORA[corpus]("port")
    for f in dataclasses.fields(cj):
        assert _equal(getattr(cj, f.name), getattr(ct, f.name)), f.name
    assert (ct.n_device_rows, ct.n_op_rows) == (cj.n_device_rows,
                                                cj.n_op_rows)


def test_merge_tuples_refuses_an_empty_list():
    with pytest.raises(ValueError, match="at least one part"):
        TS.merge_tuples([])


# -- the prior -------------------------------------------------------------------

def _fit(pkg, corpus, heads=("device", "op"), ridge=1e-2):
    B = PKGS[pkg][0]
    kw = {"ridge": ridge}
    if "device" in heads:
        kw.update(device_features=corpus.device_features,
                  device_log_degrade=corpus.device_log_degrade,
                  device_weights=corpus.device_weights)
    if "op" in heads:
        kw.update(op_features=corpus.op_features,
                  op_log_sel_scale=corpus.op_log_sel_scale,
                  op_weights=corpus.op_weights)
    if pkg == "port":
        kw["device"] = CPU
    return B.fit_prior(**kw)


@pytest.mark.parametrize("corpus,ridge", [("planted", 1.0),
                                          ("bench_belief", 1e-2),
                                          ("bench_belief", 1.0)])
def test_prior_coefficients_match_the_jax_fit(corpus, ridge):
    c = CORPORA[corpus]("jax")
    pj, pt = _fit("jax", c, ridge=ridge), _fit("port", c, ridge=ridge)
    for head in ("w_device", "w_op"):
        wj, wt = getattr(pj, head), getattr(pt, head)
        if wj is None:
            assert wt is None
            continue
        assert wt.dtype == np.float64 and wt.shape == wj.shape
        assert _rel(wt, wj) <= COEF_REL, head
    assert (pt.n_device_samples, pt.n_op_samples) == \
        (pj.n_device_samples, pj.n_op_samples)
    for f in ("device_residual_var", "op_residual_var"):
        assert abs(getattr(pt, f) - getattr(pj, f)) \
            <= COEF_REL * max(abs(getattr(pj, f)), 1e-4), f


def _exact(x, y, sw, ridge):
    """The float64 minimizer of the ridge loss and the condition number of
    its normal equations."""
    d = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    s = sw / sw.mean()
    g = (d * s[:, None]).T @ d + np.diag([0.0] + [ridge] * x.shape[1])
    return np.linalg.solve(g, (d * s[:, None]).T @ y), np.linalg.cond(g), d


def test_planted_tuples_at_the_default_ridge_are_ill_conditioned():
    """tests/test_belief.py:81's planted tuples at ridge 1e-2: the tier
    one-hots add up to the bias column, so only the ridge pins that
    direction and the float32 normal equations have condition > 10⁴.  The
    JAX fit itself then lies more than 1e-5 from the exact float64
    minimizer, so no other float32 solve can be held to it at 1e-5 (the
    port's lies 2.0e-4 / 8.5e-5 from it on the two heads; ROADMAP.md,
    Queue C).  What the fit determines agrees: the predictions on the
    tuples within 1e-5 and the float32 training loss within 1e-6."""
    c = CORPORA["planted"]("jax")
    pj, pt = _fit("jax", c), _fit("port", c)
    for head, x, y, sw in (
            ("w_device", c.device_features, c.device_log_degrade,
             c.device_weights),
            ("w_op", c.op_features, c.op_log_sel_scale, c.op_weights)):
        wj, wt = getattr(pj, head), getattr(pt, head)
        exact, cond, d = _exact(x, y, sw, 1e-2)
        assert cond > 1e4 and _rel(wj, exact) > COEF_REL, head
        assert _rel(d @ wt, d @ wj) <= COEF_REL, head
        s = sw / sw.mean()
        want = JB.ridge_loss(wj, x, y, s, 1e-2)
        got = TB.ridge_loss(wt, x, y, s, 1e-2, device=CPU)
        assert abs(got - want) <= LOSS_REL * want, head


def test_the_solve_is_exact_on_a_well_posed_system():
    """The elimination and the pairwise Gram against float64 on a random
    well-conditioned corpus: ≤1e-5, and bitwise on a repeat."""
    from repro_torch.belief import prior

    rng = np.random.default_rng(12)
    x = rng.normal(size=(300, 6))
    y = x @ rng.normal(size=6) + 0.3 + 0.01 * rng.normal(size=300)
    sw = rng.uniform(0.5, 2.0, 300)
    exact, cond, _ = _exact(x, y, sw, 0.5)
    assert cond < 1e3
    w = prior._fit_head(x, y, sw, 0.5, torch.device(CPU))
    assert _rel(w, exact) <= COEF_REL
    assert np.array_equal(w, prior._fit_head(x, y, sw, 0.5,
                                             torch.device(CPU)))
    t = torch.as_tensor(rng.normal(size=(37, 3, 2)), dtype=torch.float32)
    assert _rel(prior._pairwise_sum(t), t.double().sum(0)) <= 1e-6


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_ridge_loss_matches_the_jax_loss(corpus):
    c = CORPORA[corpus]("jax")
    pj = _fit("jax", c)
    for w, feats, y, sw in ((pj.w_device, c.device_features,
                             c.device_log_degrade, c.device_weights),
                            (pj.w_op, c.op_features, c.op_log_sel_scale,
                             c.op_weights)):
        if w is None:
            continue
        sw = sw / sw.mean()
        for lam in (1e-2, 3.0):
            want = JB.ridge_loss(w, feats, y, sw, lam)
            got = TB.ridge_loss(w, feats, y, sw, lam, device=CPU)
            assert abs(got - want) <= LOSS_REL * abs(want)


def test_the_fit_minimizes_its_loss():
    """The solve is the loss's minimizer: nudging any coefficient raises
    the float32 loss (on the planted corpus, device head)."""
    c = CORPORA["planted"]("port")
    p = _fit("port", c, heads=("device",))
    sw = c.device_weights / c.device_weights.mean()
    args = (c.device_features, c.device_log_degrade, sw, 1e-2)
    best = TB.ridge_loss(p.w_device, *args, device=CPU)
    for k in range(p.w_device.size):
        for step in (-1e-2, 1e-2):
            w = p.w_device.copy()
            w[k] += step
            assert TB.ridge_loss(w, *args, device=CPU) > best


@pytest.mark.parametrize("heads", [(), ("device",), ("op",)])
def test_absent_heads_predict_healthy(heads):
    c = CORPORA["planted"]("jax")
    pj, pt = _fit("jax", c, heads), _fit("port", c, heads)
    for f in ("n_device_samples", "n_op_samples", "device_residual_var",
              "op_residual_var"):
        if not heads:
            assert getattr(pt, f) == getattr(pj, f), f
    feats = TB.device_features(_random_fleet(TD, np.random.default_rng(5)))
    if "device" not in heads:
        assert _equal(pt.predict_degrade(feats), np.ones(feats.shape[0]))
    if "op" not in heads:
        assert _equal(pt.predict_sel_scale(c.op_features),
                      np.ones(c.op_features.shape[0]))


def test_fit_prior_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = CORPORA["planted"]("port")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.fit_prior(device_features=c.device_features,
                     device_log_degrade=c.device_log_degrade)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.ridge_loss(np.zeros(9), c.device_features, c.device_log_degrade,
                      np.ones(c.n_device_rows), 1.0)


def _handoff(pj):
    return TB.LearnedPrior(**{f.name: getattr(pj, f.name)
                              for f in dataclasses.fields(pj)})


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_a_jax_prior_handed_to_the_port_gives_the_same_posterior(corpus):
    """Weights and state are numpy in both packages: a LearnedPrior fit in
    JAX, handed over as its arrays, gives the port's BeliefState the same
    posterior means and variances bitwise."""
    pj = _fit("jax", CORPORA[corpus]("jax"))
    pt = _handoff(pj)
    fj = _random_fleet(JD, np.random.default_rng(99))
    ft = _random_fleet(TD, np.random.default_rng(99))
    bj = JB.BeliefState.from_fleet(fj, graph=_chain_graph(JG), prior=pj)
    bt = TB.BeliefState.from_fleet(ft, graph=_chain_graph(TG), prior=pt)
    for f in ("posterior_mean_log", "posterior_mean_degrade",
              "posterior_var", "op_posterior_mean_log"):
        assert _equal(getattr(bj, f)(), getattr(bt, f)()), f
    assert _equal(pj.predict_degrade(JB.device_features(fj)),
                  pt.predict_degrade(TB.device_features(ft)))


# -- the posterior ---------------------------------------------------------------

def _state_run(pkg, seed, with_prior):
    """One BeliefState through every operation the controller uses, in
    package ``pkg``: its arrays, the sampled fleets and the generator's
    state afterwards."""
    B, C, D, G, S, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    fleet = _random_fleet(D, rng, v=6)
    graph = _chain_graph(G)
    prior = None
    if with_prior:
        pj = _fit("jax", CORPORA["planted"]("jax"))
        prior = pj if pkg == "jax" else _handoff(pj)
    b = B.BeliefState.from_fleet(fleet, graph=graph, prior=prior,
                                 prior_strength=3.0)
    b.observe(rng.normal(size=6), np.where(rng.random(6) < 0.5,
                                           rng.uniform(0.5, 2.0, 6), 0.0))
    window = _synthetic_window(C, graph, fleet, _planted(B, fleet, 4.0),
                               np.array([1.0, 0.8, 1.3]))
    refit = C.refit_from_replay(graph, fleet, window, work_unit=1e-3,
                                belief=b)
    b.commit(refit.degrade)
    b.decay(0.7)
    rel = b.sample_degrade_rel(rng, 5)
    fleets = b.sample_fleets(fleet, rng, 3)
    small = b.without_devices(np.array([0, 2, 3, 5]))
    arrays = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    arrays.update(small_mean=small.posterior_mean_log(),
                  small_var=small.posterior_var(), rel=rel,
                  posterior_var=refit.posterior_var,
                  applied=B.apply_degrade(fleet, rel[0]).com_cost)
    return arrays, fleets, rng.bit_generator.state


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("with_prior", [False, True])
def test_belief_state_is_bitwise_the_reference(seed, with_prior):
    (aj, fj, sj), (at, ft, st) = (_state_run(p, seed, with_prior)
                                  for p in ("jax", "port"))
    assert aj.keys() == at.keys()
    for k in aj:
        assert _equal(aj[k], at[k]), k
    for a, b in zip(fj, ft):
        assert _equal(a.com_cost, b.com_cost) and _equal(a.speed, b.speed)
    assert sj == st


# -- belief-sampled robust search -----------------------------------------------

def _after_one_refit(pkg):
    """A BeliefState after one refit on a planted window, its believed
    fleet, and the graph."""
    B, C, D, G, S, _ = PKGS[pkg]
    fleet = _random_fleet(D, np.random.default_rng(21), v=6)
    graph = _chain_graph(G)
    belief = B.BeliefState.from_fleet(fleet, graph=graph)
    window = _synthetic_window(C, graph, fleet, _planted(B, fleet, 5.0),
                               np.ones(3))
    refit = C.refit_from_replay(graph, fleet, window, work_unit=1e-3,
                                belief=belief)
    belief.commit(refit.degrade)
    return graph, belief, refit.fleet


@pytest.mark.parametrize("kw", [
    dict(n_candidates=48),
    dict(n_candidates=48, warm_start=False, beta=0.5, dq=0.3),
    dict(n_candidates=32, beta=1.0, co_optimize_dq=True, dq_steps=4)],
    ids=["warm_start", "fixed_dq", "co_optimize_dq"])
def test_belief_robust_search_picks_the_jax_winner(kw):
    (gj, bj, fj), (gt, bt, ft) = _after_one_refit("jax"), \
        _after_one_refit("port")
    rj = JSe.belief_robust_search(gj, bj, fj, np.random.default_rng(3),
                                  n_scenarios=4, **kw)
    rt = TSe.belief_robust_search(gt, bt, ft, np.random.default_rng(3),
                                  n_scenarios=4, device=CPU, **kw)
    assert np.array_equal(rt.x, rj.x)
    assert rt.dq_fraction == rj.dq_fraction
    assert rt.evals == rj.evals and rt.dispatches == rj.dispatches
    assert abs(rt.F - rj.F) <= 1e-12 * abs(rj.F)


def test_belief_scenarios_are_bitwise_the_reference():
    (gj, bj, fj), (gt, bt, ft) = _after_one_refit("jax"), \
        _after_one_refit("port")
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    sj = JSe.belief_scenarios(bj, fj, rj, 5, graph=gj, beta=0.25)
    st = TSe.belief_scenarios(bt, ft, rt, 5, graph=gt, beta=0.25)
    assert [s.name for s in st] == [s.name for s in sj]
    assert st[0].fleet is ft and all(s.beta == 0.25 for s in st)
    for a, b in zip(sj, st):
        assert _equal(a.fleet.com_matrix(), b.fleet.com_matrix())
    assert rj.bit_generator.state == rt.bit_generator.state


# -- chip_smoke.py's phase 14, rehearsed on the CPU ----------------------------

def test_chip_smoke_belief_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phases 13 and 14 at 8 regions × 3 devices, K1 swapped
    for a counted plain version: the prior's card-vs-CPU check, the cold
    start's launches, the passive belief bitwise against phase 13's legacy
    run, and belief-robust search against the oracle."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import edge_latency as kernels

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))

    def run(*args, config=None):     # the policy's config: one function
        kernels.launches["edge_latency_dense"] += 1
        return ref.edge_latency_dense_plain(*args)

    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    monkeypatch.setattr(kernels, "edge_latency_dense", run)
    monkeypatch.setitem(kernels.launches, "edge_latency_dense", 0)
    cpu = torch.device(CPU)
    legacy = chip_smoke.adaptive_dense_phase(torch, np, cpu, 3, 12,
                                             profile=False)
    out = chip_smoke.belief_cold_start_phase(torch, np, cpu, 3, 8, legacy)
    assert out["launches"] == 4 * out["rep"].controller_dispatches > 0
    assert out["search"].dispatches == 1
    assert _equal(out["prior"].w_device, out["prior_cpu"].w_device)
    assert "belief_cold_start: " in capsys.readouterr().out
