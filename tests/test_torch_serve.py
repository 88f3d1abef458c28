"""The port's ``WhatIfService`` (``device="cpu"``) against the JAX
``WhatIfService`` on the same queries (≤1e-5), and the serving contract of
``tests/test_serve.py``: served scores BITWISE equal to the port's own
direct ``score_grid`` with the same dq/β, chunk streaming, coalescing,
typed admission verdicts, the multi-objective kinds (objective sets,
pareto, ε-constraint rank) against the decision layer and the JAX
service, the query surface's validation, and chip_smoke.py's
multi-objective serving phases rehearsed on the CPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import ExplicitFleet, random_dag, random_placement  # noqa: E402
from repro.serve import WhatIfQuery as JaxQuery  # noqa: E402
from repro.serve import WhatIfService as JaxService  # noqa: E402
from repro.serve import AdmissionConfig as JaxAdmission  # noqa: E402
from repro.serve import QueryResult as JaxResult  # noqa: E402
from repro.sim import pack_fleets as jax_pack_fleets  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro.core import ObjectiveSet as JaxSet  # noqa: E402
from repro_torch.core import ObjectiveSet  # noqa: E402
from repro_torch.search.decision import (epsilon_constraint,  # noqa: E402
                                         joint_dq_scores, pareto_front,
                                         robust_select, split_dq_term)
from repro_torch.serve.bucketing import finish_scores  # noqa: E402
from repro_torch.serve import (AdmissionConfig, Degraded, QueryResult,  # noqa: E402
                               Rejected, ResultChunk, WhatIfQuery,
                               WhatIfService, fleet_digest, next_pow2,
                               pad_rows)
from repro_torch.sim import BatchedEvaluator  # noqa: E402

RELAXED = AdmissionConfig(p99_budget_s=1e6)
REL = 1e-5
OBJ2 = ObjectiveSet.from_weights(latency_f=1.0, network_movement=0.05)


def _port_graph(g):
    ops = g.operators
    return convert.graph_from_arrays(
        [o.name for o in ops], [o.selectivity for o in ops],
        [o.out_bytes for o in ops], [o.work for o in ops],
        [o.dq_eligible for o in ops], g.edges)


def _setup(seed=0, n_ops=5, n_dev=6, n_fleets=3):
    rng = np.random.default_rng(seed)
    g = random_dag(n_ops, edge_prob=0.6, rng=rng)
    fleets = []
    for _ in range(n_fleets):
        com = rng.uniform(0.1, 3.0, (n_dev, n_dev))
        com = (com + com.T) / 2
        np.fill_diagonal(com, 0.0)
        fleets.append(ExplicitFleet(com_cost=com))
    coms = np.array(jax_pack_fleets(fleets))

    def placements(n):
        return np.stack([
            random_placement(n_ops, np.ones((n_ops, n_dev), bool), rng)
            for _ in range(n)]).astype(np.float32)

    return g, coms, placements


def _result(msgs, qid, cls=QueryResult):
    (res,) = [m for m in msgs if isinstance(m, cls) and m.query_id == qid]
    return res


def _queries(coms, placements):
    S = coms.shape[0]
    return [
        ("alice", dict(kind="score", placements=placements(7), dq=0.3,
                       beta=0.7)),
        ("bob", dict(kind="rank", placements=placements(3), top_k=2)),
        ("carol", dict(kind="score", placements=placements(11),
                       dq=np.linspace(0.1, 0.8, S), beta=1.3)),
        ("alice", dict(kind="joint", placements=placements(5), beta=0.9,
                       dq_values=np.linspace(0.0, 0.9, 7))),
    ]


def _jax_region_family(rng, n_dev, n_fleets):
    from repro.core import RegionFleet
    from repro.sim import pack_region_fleets
    region = rng.integers(0, 3, n_dev)
    return pack_region_fleets([
        RegionFleet(region=region, inter=rng.uniform(0.1, 2.0, (3, 3)),
                    self_cost=0.05, degrade=rng.uniform(1.0, 2.5, n_dev))
        for _ in range(n_fleets)])


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_served_results_match_the_jax_service(kind):
    g, coms, placements = _setup()
    queries = _queries(coms, placements)
    if kind == "dense":
        jpack, pack = coms, convert.dense_pack_from_array(coms)
    else:
        jpack = _jax_region_family(np.random.default_rng(11), coms.shape[1],
                                   coms.shape[0])
        pack = convert.region_family_from_arrays(
            jpack.region, jpack.inter, jpack.degrade, jpack.self_cost,
            jpack.speed)
    jsvc = JaxService(g, admission=JaxAdmission(p99_budget_s=1e6))
    jfid = jsvc.register_fleet("t", jpack)
    jt = [jsvc.submit(t, jfid, JaxQuery(**q)) for t, q in queries]
    jsvc.drain()
    svc = WhatIfService(_port_graph(g), device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", pack)
    pt = [svc.submit(t, fid, WhatIfQuery(**q)) for t, q in queries]
    svc.drain()
    jmail = {t: jsvc.poll(t) for t in ("alice", "bob", "carol")}
    pmail = {t: svc.poll(t) for t in ("alice", "bob", "carol")}
    for (tenant, q), a, b in zip(queries, jt, pt):
        want = _result(jmail[tenant], a.query_id, JaxResult)
        got = _result(pmail[tenant], b.query_id)
        assert got.kind == want.kind == q["kind"]
        np.testing.assert_allclose(got.scores, want.scores, rtol=REL,
                                   atol=0)
        if q["kind"] == "rank":
            np.testing.assert_array_equal(got.top, want.top)
            assert got.best == want.best
        if q["kind"] == "joint":
            np.testing.assert_array_equal(got.dq_idx, want.dq_idx)
            assert got.best == want.best


def test_interleaved_tenants_bitwise_parity():
    """Many tenants, different row counts, scalar AND per-scenario dq, all
    merged into one padded dispatch: every tenant's scores are BITWISE a
    direct score_grid with the same dq/β over the rows as dispatched, and
    exactly their own rows (no padding, no neighbour rows leak)."""
    g, coms, placements = _setup(1)
    tg = _port_graph(g)
    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("anyone", coms)
    queries = [(t, q) for t, q in _queries(coms, placements)
               if q["kind"] == "score"] + [
        ("bob", dict(kind="score", placements=placements(2), dq=0.9,
                     beta=0.2))]
    tickets = [svc.submit(t, fid, WhatIfQuery(**q)) for t, q in queries]
    svc.drain()
    batch = np.concatenate([q["placements"] for _, q in queries])
    batch = pad_rows(batch, next_pow2(batch.shape[0]))   # as dispatched
    ev = BatchedEvaluator.shared(tg, device="cpu")
    mail = {t: svc.poll(t) for t in ("alice", "bob", "carol")}
    off = 0
    for (tenant, q), tk in zip(queries, tickets):
        res = _result(mail[tenant], tk.query_id)
        rows = slice(off, off + q["placements"].shape[0])
        off = rows.stop
        direct = ev.score_grid(batch, coms, dq=q["dq"],
                               beta=q["beta"]).numpy()[:, rows]
        np.testing.assert_array_equal(res.scores, direct)
        # a direct call on the tenant's rows alone: the CPU plain version's
        # BLAS product may block the sums differently for another row
        # count (MKL chooses its kernel by shape), so the last bit can move
        alone = ev.score_grid(q["placements"], coms, dq=q["dq"],
                              beta=q["beta"]).numpy()
        np.testing.assert_allclose(res.scores, alone, rtol=1e-6, atol=0)


def test_rank_and_joint_match_the_decision_layer():
    g, coms, placements = _setup(2)
    tg = _port_graph(g)
    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", coms)
    x = placements(9)
    dqv = np.linspace(0.0, 0.9, 7)

    class Coupling:            # duck-typed DQCoupling: caps = cap0 − dq·load
        cap0 = np.full(coms.shape[1], 3.0)
        load = np.full(coms.shape[1], 2.0)

    t_rank = svc.submit("t", fid, WhatIfQuery(
        kind="rank", placements=x, dq=0.2, beta=0.5, top_k=4))
    t_joint = svc.submit("t", fid, WhatIfQuery(
        kind="joint", placements=x, beta=0.9, dq_values=dqv,
        coupling=Coupling()))
    svc.drain()
    msgs = svc.poll("t")
    ev = BatchedEvaluator.shared(tg, device="cpu")
    batch = pad_rows(np.concatenate([x, x]), 32)     # as dispatched
    rank = _result(msgs, t_rank.query_id)
    best, worst = robust_select(
        ev.score_grid(batch, coms, dq=0.2, beta=0.5).numpy()[:, :9])
    np.testing.assert_array_equal(rank.worst, worst)
    assert rank.top[0] == best and len(rank.top) == 4
    joint = _result(msgs, t_joint.query_id)
    from repro_torch.search.decision import dq_caps_mask
    want, want_idx = joint_dq_scores(
        ev.score_grid(batch, coms).numpy()[:, 9:18], dqv, 0.9,
        feasible=dq_caps_mask(x, dqv, Coupling()))
    np.testing.assert_array_equal(joint.scores, want)
    np.testing.assert_array_equal(joint.dq_idx, want_idx)
    assert joint.best == robust_select(want)[0]


def test_chunking_streams_partials_and_pads_safely():
    g, coms, placements = _setup(3)
    tg = _port_graph(g)
    svc = WhatIfService(tg, device="cpu", admission=RELAXED,
                        max_chunk_rows=8)
    fid = svc.register_fleet("t", coms)
    x = placements(13)              # spans 2 chunks: 8 + 5 (padded to 8)
    tk = svc.submit("t", fid, WhatIfQuery(kind="score", placements=x,
                                          dq=0.4, beta=0.6))
    svc.drain()
    msgs = svc.poll("t")
    chunks = [m for m in msgs if isinstance(m, ResultChunk)]
    res = _result(msgs, tk.query_id)
    assert [c.offset for c in chunks] == [0, 8]
    assert [c.rows for c in chunks] == [8, 5]
    np.testing.assert_array_equal(
        np.concatenate([c.scores for c in chunks], axis=1), res.scores)
    ev = BatchedEvaluator.shared(tg, device="cpu")
    second = np.concatenate([x[8:], np.repeat(x[-1:], 3, axis=0)])
    np.testing.assert_array_equal(res.scores[:, :8], ev.score_grid(
        x[:8], coms, dq=0.4, beta=0.6).numpy())
    np.testing.assert_array_equal(res.scores[:, 8:], ev.score_grid(
        second, coms, dq=0.4, beta=0.6).numpy()[:, :5])


def test_equal_fleets_coalesce_into_one_dispatch():
    g, coms, placements = _setup(4)
    svc = WhatIfService(_port_graph(g), device="cpu", admission=RELAXED)
    fa = svc.register_fleet("a", coms.copy())
    fb = svc.register_fleet("b", torch.from_numpy(coms.copy()))
    assert fa == fb == fleet_digest(coms)
    svc.submit("a", fa, WhatIfQuery(kind="score", placements=placements(4)))
    svc.submit("b", fb, WhatIfQuery(kind="score", placements=placements(4),
                                    dq=0.5, beta=2.0))
    svc.drain()
    snap = svc.stats.snapshot()
    assert len(snap["buckets"]) == 1
    b = snap["buckets"][0]
    assert (b["dispatches"], b["queries"], b["rows"]) == (1, 2, 8)
    assert b["recompiles"] == 0 and snap["setup_s"] == 0.0


def test_admission_rejects_and_degrades_typed():
    g, coms, placements = _setup(5)
    tg = _port_graph(g)
    x = placements(64)
    svc = WhatIfService(tg, device="cpu", admission=AdmissionConfig(
        p99_budget_s=0.0, allow_degrade=False))
    fid = svc.register_fleet("t", coms)
    verdict = svc.submit("t", fid, WhatIfQuery(kind="score", placements=x))
    assert isinstance(verdict, Rejected)
    assert verdict.predicted_s > verdict.budget_s == 0.0
    assert svc.stats.snapshot()["admission"]["rejected"] == 1

    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", coms)
    svc.submit("t", fid, WhatIfQuery(kind="score", placements=x))
    svc.drain()
    svc.poll("t")
    price = svc._fleets[fid].pricer.price_s(coms.shape[0], 64)
    svc.admission = AdmissionConfig(p99_budget_s=price * 0.45, min_rows=8)
    tk = svc.submit("t", fid, WhatIfQuery(kind="score", placements=x,
                                          dq=0.3, beta=0.7))
    assert isinstance(tk.admission, Degraded)
    assert "subsample_candidates" in tk.admission.actions
    assert tk.rows == tk.admission.keep_rows < 64
    svc.drain()
    res = _result(svc.poll("t"), tk.query_id)
    assert res.scores.shape[1] == tk.rows and res.degraded is tk.admission


def test_unported_query_surface_raises_and_validation():
    g, coms, placements = _setup(6)
    svc = WhatIfService(_port_graph(g), device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", coms)
    # the multi-objective surface is served now: the reference's
    # validation errors on it
    with pytest.raises(ValueError, match="pass objectives= to use it"):
        svc.register_fleet("t", coms, speed=np.ones(coms.shape[1]))
    fam = convert.region_family_from_arrays(
        np.zeros(coms.shape[1]), np.ones((2, 1, 1)),
        np.ones((2, coms.shape[1])), 0.0)
    with pytest.raises(ValueError, match="carry their own speeds"):
        svc.register_fleet("t", fam, objectives=("occupancy_max",),
                           speed=np.ones(coms.shape[1]))
    with pytest.raises(ValueError, match="eps_caps needs minimize"):
        WhatIfQuery(kind="rank", placements=placements(2),
                    eps_caps={"network_movement": 1.0})
    with pytest.raises(ValueError, match="pareto queries need the fleet"):
        svc.submit("t", fid, WhatIfQuery(kind="pareto",
                                         placements=placements(2)))
    with pytest.raises(ValueError, match="ε-constraint ranking"):
        svc.submit("t", fid, WhatIfQuery(kind="rank",
                                         placements=placements(2),
                                         minimize="latency_f"))
    with pytest.raises(ValueError, match="kind"):
        WhatIfQuery(kind="nope", placements=placements(2))
    with pytest.raises(ValueError, match="dq_values"):
        WhatIfQuery(kind="joint", placements=placements(2))
    with pytest.raises(ValueError, match="devices"):
        svc.submit("t", fid, WhatIfQuery(
            kind="score", placements=np.ones((2, 5, 9), np.float32)))
    with pytest.raises(ValueError, match="power of two"):
        WhatIfService(_port_graph(g), device="cpu", max_chunk_rows=6)


def test_structured_family_serves_like_a_direct_grid():
    """A RegionFleetFamily registers, digests by content and serves scores
    bitwise equal to a direct grid over the dispatched rows."""
    from repro_torch.core.devices import RegionFleet, RegionFleetFamily
    rng = np.random.default_rng(9)
    g, _, placements = _setup(7)
    tg = _port_graph(g)
    V = 6
    region = rng.integers(0, 2, V)
    fam = RegionFleetFamily.from_fleets([
        RegionFleet(region=region, inter=rng.uniform(0.1, 2.0, (2, 2)),
                    self_cost=0.05, degrade=rng.uniform(1.0, 2.0, V))
        for _ in range(2)])
    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", fam)
    x = placements(4)
    tk = svc.submit("t", fid, WhatIfQuery(kind="score", placements=x,
                                          dq=0.5, beta=0.5))
    svc.drain()
    res = _result(svc.poll("t"), tk.query_id)
    direct = BatchedEvaluator.shared(tg, device="cpu").score_grid(
        x, fam, dq=0.5, beta=0.5).numpy()
    np.testing.assert_array_equal(res.scores, direct)


def _rows(og, rows):
    """The host ObjectiveGrids ``og`` restricted to placement ``rows``."""
    return dataclasses.replace(
        og, grids={k: v[:, rows] for k, v in og.grids.items()},
        scalarized=og.scalarized[:, rows])


def test_multi_objective_grids_parity():
    """Multi-objective serving: every finished per-objective grid is
    BITWISE the direct score_grid(objectives=) with the same dq/β over the
    rows as dispatched, and the score is bitwise the host recombination of
    the raw dispatch (split_dq_term + finish_scores); against the device's
    own finish of the scalarization it agrees to float32 resolution, as in
    the reference."""
    g, coms, placements = _setup()
    tg = _port_graph(g)
    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", coms, objectives=OBJ2)
    x = placements(6)
    dq, beta = 0.35, 0.8
    tk = svc.submit("t", fid, WhatIfQuery(kind="score", placements=x,
                                          dq=dq, beta=beta))
    svc.drain()
    res = _result(svc.poll("t"), tk.query_id)
    ev = BatchedEvaluator.shared(tg, device="cpu")
    batch = pad_rows(x, next_pow2(6))                    # as dispatched
    raw = ev.score_grid(batch, coms, objectives=OBJ2).to_host()
    direct = ev.score_grid(batch, coms, dq=dq, beta=beta,
                           objectives=OBJ2).to_host()
    for name in OBJ2.names:
        np.testing.assert_array_equal(res.grids[name],
                                      direct.grids[name][:, :6])
    np.testing.assert_array_equal(res.grids["network_movement"],
                                  raw.grids["network_movement"][:, :6])
    lat, rest, w_lat = split_dq_term(raw)
    np.testing.assert_array_equal(res.scores, finish_scores(
        np.float32(lat), np.float32(rest), w_lat, dq, beta)[:, :6])
    np.testing.assert_allclose(res.scores, direct.scalarized[:, :6],
                               rtol=1e-5, atol=1e-6)


def test_rank_pareto_joint_match_decision_layer():
    """Per-kind post-processing of multi-objective fleets == the decision
    layer applied to the direct grids over the rows as dispatched."""
    g, coms, placements = _setup()
    tg = _port_graph(g)
    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", coms, objectives=OBJ2)
    x = placements(9)
    dqv = np.linspace(0.0, 0.9, 7)
    t_par = svc.submit("t", fid, WhatIfQuery(kind="pareto", placements=x))
    t_rank = svc.submit("t", fid, WhatIfQuery(
        kind="rank", placements=x, dq=0.2, beta=0.5, top_k=4))
    t_joint = svc.submit("t", fid, WhatIfQuery(
        kind="joint", placements=x, beta=0.9, dq_values=dqv))
    svc.drain()
    msgs = svc.poll("t")
    ev = BatchedEvaluator.shared(tg, device="cpu")
    batch = pad_rows(np.concatenate([x, x, x]), 32)      # as dispatched
    raw = ev.score_grid(batch, coms, objectives=OBJ2).to_host()
    par = _result(msgs, t_par.query_id)
    want_front = pareto_front(_rows(raw, slice(0, 9)))
    np.testing.assert_array_equal(par.front.indices, want_front.indices)
    np.testing.assert_array_equal(par.front.values, want_front.values)
    assert par.front.names == OBJ2.names
    rank = _result(msgs, t_rank.query_id)
    lat, rest, w_lat = split_dq_term(raw)
    lat, rest = np.float32(lat), np.float32(rest)
    scores = finish_scores(lat, rest, w_lat, 0.2, 0.5)[:, 9:18]
    best, worst = robust_select(scores)
    np.testing.assert_array_equal(rank.worst, worst)
    assert rank.best == best and rank.top[0] == best and len(rank.top) == 4
    joint = _result(msgs, t_joint.query_id)
    want, want_idx = joint_dq_scores(lat[:, 18:27], dqv, 0.9,
                                     rest=rest[:, 18:27], w_lat=w_lat)
    np.testing.assert_array_equal(joint.scores, want)
    np.testing.assert_array_equal(joint.dq_idx, want_idx)
    assert joint.grids is not None and joint.grids.keys() == set(OBJ2.names)


def test_eps_constraint_rank_and_infeasible_flag():
    g, coms, placements = _setup()
    tg = _port_graph(g)
    svc = WhatIfService(tg, device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", coms, objectives=OBJ2)
    x = placements(8)
    t_ok = svc.submit("t", fid, WhatIfQuery(
        kind="rank", placements=x, minimize="latency_f",
        eps_caps={"network_movement": 1e9}, top_k=2))
    t_bad = svc.submit("t", fid, WhatIfQuery(
        kind="rank", placements=x, minimize="latency_f",
        eps_caps={"network_movement": -1.0}))
    svc.drain()
    msgs = svc.poll("t")
    ok = _result(msgs, t_ok.query_id)
    grids = _rows(BatchedEvaluator.shared(tg, device="cpu").score_grid(
        pad_rows(np.concatenate([x, x]), 16), coms,
        objectives=OBJ2).to_host(), slice(0, 8))
    want_idx, want = epsilon_constraint(grids, "latency_f",
                                        {"network_movement": 1e9})
    assert not ok.infeasible and ok.top[0] == want_idx == ok.best
    np.testing.assert_array_equal(ok.worst, want)
    bad = _result(msgs, t_bad.query_id)
    assert bad.infeasible and np.all(np.isinf(bad.worst))


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_multi_objective_service_matches_the_jax_service(kind):
    """Objective-set fleets served by the port and by the JAX service on
    the same queries: scores and every per-objective grid within 1e-5, the
    same front, the same ε-constraint and joint choices."""
    g, coms, placements = _setup(5)
    if kind == "dense":
        jpack, pack = coms, convert.dense_pack_from_array(coms)
    else:
        jpack = _jax_region_family(np.random.default_rng(12), coms.shape[1],
                                   coms.shape[0])
        pack = convert.region_family_from_arrays(
            jpack.region, jpack.inter, jpack.degrade, jpack.self_cost,
            jpack.speed)
    names = ("latency_f", "network_movement_cost", "occupancy_imbalance")
    S = coms.shape[0]
    queries = [
        ("alice", dict(kind="score", placements=placements(5), dq=0.3,
                       beta=0.7)),
        ("bob", dict(kind="pareto", placements=placements(12))),
        ("carol", dict(kind="rank", placements=placements(7),
                       dq=np.linspace(0.1, 0.8, S), beta=1.1, top_k=3,
                       minimize="latency_f",
                       eps_caps={"occupancy_imbalance": 1e9})),
        ("alice", dict(kind="joint", placements=placements(4), beta=0.9,
                       dq_values=np.linspace(0.0, 0.9, 5))),
    ]
    jsvc = JaxService(g, admission=JaxAdmission(p99_budget_s=1e6))
    jfid = jsvc.register_fleet("t", jpack, objectives=JaxSet.of(*names))
    jt = [jsvc.submit(t, jfid, JaxQuery(**q)) for t, q in queries]
    jsvc.drain()
    svc = WhatIfService(_port_graph(g), device="cpu", admission=RELAXED)
    fid = svc.register_fleet("t", pack, objectives=ObjectiveSet.of(*names))
    pt = [svc.submit(t, fid, WhatIfQuery(**q)) for t, q in queries]
    svc.drain()
    jmail = {t: jsvc.poll(t) for t in ("alice", "bob", "carol")}
    pmail = {t: svc.poll(t) for t in ("alice", "bob", "carol")}
    for (tenant, q), a, b in zip(queries, jt, pt):
        want = _result(jmail[tenant], a.query_id, JaxResult)
        got = _result(pmail[tenant], b.query_id)
        assert got.kind == want.kind == q["kind"]
        np.testing.assert_allclose(got.scores, want.scores, rtol=REL,
                                   atol=1e-6)
        for name in names:
            np.testing.assert_allclose(got.grids[name], want.grids[name],
                                       rtol=REL, atol=1e-6, err_msg=name)
        if q["kind"] == "pareto":
            np.testing.assert_array_equal(got.front.indices,
                                          want.front.indices)
        if q["kind"] in ("rank", "joint"):
            assert got.best == want.best and not got.infeasible
        if q["kind"] == "rank":
            np.testing.assert_array_equal(got.top, want.top)


def test_objective_sets_and_speeds_key_their_own_dispatch():
    """Two objective sets (or two speed vectors) on one pack get distinct
    fleet ids and coalesce keys; equal registrations share one."""
    g, coms, placements = _setup(8)
    svc = WhatIfService(_port_graph(g), device="cpu", admission=RELAXED)
    plain = svc.register_fleet("a", coms)
    f1 = svc.register_fleet("a", coms, objectives=OBJ2)
    f1b = svc.register_fleet("b", coms, objectives=ObjectiveSet.from_weights(
        latency_f=1.0, network_movement=0.05))
    f2 = svc.register_fleet("b", coms, objectives=ObjectiveSet.from_weights(
        latency_f=1.0, network_movement=0.5))
    V = coms.shape[1]
    f3 = svc.register_fleet("c", coms, objectives=OBJ2,
                            speed=np.full(V, 2.0))
    f3b = svc.register_fleet("c", coms, objectives=OBJ2,
                             speed=np.full((coms.shape[0], V), 2.0))
    f4 = svc.register_fleet("c", coms, objectives=OBJ2,
                            speed=np.full(V, 3.0))
    assert f1 == f1b and f3 == f3b
    ids = [plain, f1, f2, f3, f4]
    assert len(set(ids)) == 5
    assert len({svc._fleets[f].key for f in ids}) == 5
    assert svc._fleets[f1].key.objectives == OBJ2
    # the speed reaches the occupancy objectives: twice the speed, half
    # the occupancy
    occ = ObjectiveSet.of("occupancy_max")
    fa = svc.register_fleet("d", coms, objectives=occ)
    fb = svc.register_fleet("d", coms, objectives=occ,
                            speed=np.full(V, 2.0))
    x = placements(4)
    ta = svc.submit("d", fa, WhatIfQuery(kind="score", placements=x))
    tb = svc.submit("d", fb, WhatIfQuery(kind="score", placements=x))
    svc.drain()
    msgs = svc.poll("d")
    np.testing.assert_allclose(
        _result(msgs, tb.query_id).grids["occupancy_max"],
        _result(msgs, ta.query_id).grids["occupancy_max"] / 2, rtol=1e-6)


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
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import edge_latency as kernels

    def counted(name, fn):
        def run(*args, config=None):     # every config: one function
            kernels.launches[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    for name, fn in (("edge_latency_dense", ref.edge_latency_dense_plain),
                     ("edge_latency_structured",
                      ref.edge_latency_structured_plain)):
        monkeypatch.setattr(kernels, name, counted(name, fn))
        monkeypatch.setitem(kernels.launches, name, 0)


def _rehearsal_placements(rng, rows, n_ops, V, density):
    """chip_smoke's placements, made with numpy."""
    w = -np.log1p(-rng.random((rows, n_ops, V))) \
        * (rng.random((rows, n_ops, V)) < density)
    w[np.arange(rows)[:, None], np.arange(n_ops)[None, :],
      rng.integers(0, V, (rows, n_ops))] = 1.0
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_chip_smoke_serve_multi_phases_rehearse_on_the_cpu(monkeypatch,
                                                           capsys, kind):
    """chip_smoke.py's serve_multi_dense / serve_multi_structured phases
    at a small V on the CPU, K1/K2 swapped for counted plain versions and
    planned "cuda": the launch count (S in one dispatch), the bitwise
    served == direct checks over the padded chunk, the oracle cells and
    the decision-layer checks all run."""
    from repro_torch.core.devices import ExplicitFleet, RegionFleetFamily
    from repro_torch.core.graph import random_dag as port_dag
    chip_smoke = _chip_smoke()
    _counted_plain_kernels(monkeypatch)
    rng = np.random.default_rng(0)
    S = chip_smoke.S
    graph = port_dag(chip_smoke.N_OPS, chip_smoke.EDGE_PROB, rng)
    if kind == "dense":
        V = 40
        pack = rng.uniform(0.5, 4.0, (S, V, V)).astype(np.float32)
        for s in range(S):
            np.fill_diagonal(pack[s], 0.0)
        speeds = rng.lognormal(0.0, 0.3, (S, V)).astype(np.float32)
        rows, kernel = (20, 7, 6, 3), "edge_latency_dense"

        def oracle(s):
            return ExplicitFleet(com_cost=pack[s].astype(np.float64),
                                 speed=speeds[s].astype(np.float64))
    else:
        V, R = 300, 8
        inter = rng.uniform(0.5, 4.0, (S, R, R))
        pack = RegionFleetFamily(
            region=rng.integers(0, R, V),
            inter=(inter + inter.transpose(0, 2, 1)) / 2,
            degrade=np.where(rng.random((S, V)) < 0.05,
                             rng.uniform(1.5, 4.0, (S, V)), 1.0),
            self_cost=0.01)
        speeds, rows, kernel, oracle = None, (9, 5, 5, 2), \
            "edge_latency_structured", pack.fleet
    xs = _rehearsal_placements(rng, sum(rows), chip_smoke.N_OPS, V, 0.2)
    phase = f"serve_multi_{kind}"
    out = chip_smoke.serve_multi_phase(
        torch, np, torch.device("cpu"), phase, graph, pack, xs, rows,
        speeds, kernel, oracle, profile=False)
    assert out["launches"][kernel] == S
    assert out["oracle_rel"] <= chip_smoke.REL and out["peak"] is None
    printed = capsys.readouterr().out
    assert f"{phase}: 4 queries (score, rank, pareto, joint)" in printed
    assert "served grids and scores == direct bitwise" in printed
