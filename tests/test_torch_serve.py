"""The port's ``WhatIfService`` (``device="cpu"``) against the JAX
``WhatIfService`` on the same queries (≤1e-5), and the serving contract of
``tests/test_serve.py``: served scores BITWISE equal to the port's own
direct ``score_grid`` with the same dq/β, chunk streaming, coalescing,
typed admission verdicts, and the parts of the query surface this slice
does not serve yet."""

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
from repro_torch.search.decision import joint_dq_scores, robust_select  # noqa: E402
from repro_torch.serve import (AdmissionConfig, Degraded, QueryResult,  # noqa: E402
                               Rejected, ResultChunk, WhatIfQuery,
                               WhatIfService, fleet_digest, next_pow2,
                               pad_rows)
from repro_torch.sim import BatchedEvaluator  # noqa: E402

RELAXED = AdmissionConfig(p99_budget_s=1e6)
REL = 1e-5


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
    with pytest.raises(NotImplementedError, match="multi-objective"):
        svc.register_fleet("t", coms, objectives=("latency_f",))
    with pytest.raises(NotImplementedError, match="pareto"):
        WhatIfQuery(kind="pareto", placements=placements(2))
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
