"""The port's multi-objective layer (``repro_torch.core.objectives``,
``BatchedEvaluator.score_grid(objectives=...)`` on ``device="cpu"``, and
the Pareto / ε-constraint / normalization helpers of
``repro_torch.search.decision``) — the mirror of tests/test_objectives.py
and of tests/test_search.py's decision-layer tests:

* every batched twin, dense and structured, against its float64 oracle
  (degrade ≠ 1, α > 0, per-scenario dq, S == 1 broadcast), ≤1e-5 relative
  (abs 1e-6), the tolerance tests/test_objectives.py uses;
* the port's grids against the JAX ``score_grid(objectives=...)`` on the
  same inputs, ≤1e-5 relative (abs 1e-6);
* the decision helpers against the JAX package's on the same values.

Instances are drawn with numpy from a seed, as in tests/test_objectives.py
(there with hypothesis, here one parametrized case per seed)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import CostConfig as JaxCfg  # noqa: E402
from repro.core import ObjectiveSet as JaxSet  # noqa: E402
from repro.core import RegionFleet as JaxRegionFleet  # noqa: E402
from repro.core import random_dag, random_placement  # noqa: E402
from repro.search import decision as jdec  # noqa: E402
from repro.sim import BatchedEvaluator as JaxEvaluator  # noqa: E402
from repro.sim import pack_fleets as jax_pack_fleets  # noqa: E402
from repro.sim import pack_region_fleets as jax_pack_region  # noqa: E402
from repro.sim import pack_speeds as jax_pack_speeds  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (OBJECTIVES, CostConfig, ObjectiveGrids,  # noqa: E402
                              ObjectiveSet, RegionFleet, as_objective_set,
                              device_occupancy, network_movement)
from repro_torch.core.devices import ExplicitFleet  # noqa: E402
from repro_torch.search import decision as dec  # noqa: E402
from repro_torch.sim import (BatchedEvaluator, pack_fleets,  # noqa: E402
                             pack_placements, pack_region_fleets,
                             pack_speeds)

REL = 1e-5
ALL_OBJECTIVES = tuple(sorted(OBJECTIVES))
WEIGHTS = [0.5 + 0.25 * k for k in range(len(ALL_OBJECTIVES))]


def _port_graph(g):
    ops = g.operators
    return convert.graph_from_arrays(
        [o.name for o in ops], [o.selectivity for o in ops],
        [o.out_bytes for o in ops], [o.work for o in ops],
        [o.dq_eligible for o in ops], g.edges)


def _payload_dag(rng, n_ops):
    """tests/test_objectives.py's: every operator carries out_bytes/work,
    so no objective is degenerate."""
    g = random_dag(n_ops, edge_prob=0.5, rng=rng)
    return type(g)(
        [dataclasses.replace(op,
                             out_bytes=float(rng.uniform(0.25, 4.0)),
                             work=float(rng.uniform(0.05, 0.5)))
         for op in g.operators],
        list(g.edges))


def _region_fleets(rng, n_dev, n_fleets):
    """RegionFleets sharing one layout (random inter, lognormal speeds,
    degrade ≠ 1 on all but the first) — the port's and the JAX package's
    with the same numbers."""
    n_regions = int(rng.integers(1, n_dev + 1))
    region = rng.integers(0, n_regions, n_dev)
    port, jax_ = [], []
    for k in range(n_fleets):
        inter = rng.uniform(0.1, 2.0, (n_regions, n_regions))
        inter = (inter + inter.T) / 2
        degrade = None if k == 0 else rng.uniform(1.0, 4.0, n_dev)
        speed = rng.lognormal(0.0, 0.3, n_dev)
        port.append(RegionFleet(region=region, inter=inter, degrade=degrade,
                                speed=speed))
        jax_.append(JaxRegionFleet(region=region, inter=inter,
                                   degrade=degrade, speed=speed))
    return port, jax_


def _instance(seed):
    """tests/test_objectives.py's ``instances`` strategy, from a seed."""
    rng = np.random.default_rng(seed)
    alpha = (0.0, 0.5)[seed % 2]
    n_ops = int(rng.integers(2, 7))
    n_dev = int(rng.integers(2, 8))
    g = _payload_dag(rng, n_ops)
    fleets, jfleets = _region_fleets(rng, n_dev, int(rng.integers(1, 4)))
    xs = [random_placement(n_ops, np.ones((n_ops, n_dev), bool), rng,
                           sparsity=float(rng.uniform(0.0, 0.6)))
          for _ in range(int(rng.integers(1, 4)))]
    return g, _port_graph(g), fleets, jfleets, xs, alpha


def _approx(got, want):
    return abs(float(got) - want) <= max(REL * abs(want), 1e-6)


@pytest.mark.parametrize("seed", range(10))
def test_every_twin_matches_oracle(seed):
    """One multi-objective score_grid on BOTH representations == every
    objective's scalar oracle, and the scalarization == Σ w_k·grid_k ==
    scalar_total (degrade ≠ 1, α > 0, per-scenario dq, S == 1)."""
    _, tg, fleets, _, xs, alpha = _instance(seed)
    cfg = CostConfig(alpha=alpha)
    obj = ObjectiveSet.of(*ALL_OBJECTIVES, weights=WEIGHTS)
    ev = BatchedEvaluator(tg, cfg, device="cpu")
    P = pack_placements(xs)
    beta = 0.8
    dq = np.linspace(0.1, 0.9, len(fleets))
    for pack, speed in ((pack_region_fleets(fleets), None),
                        (pack_fleets(fleets), pack_speeds(fleets))):
        res = ev.score_grid(P, pack, dq=dq, beta=beta, objectives=obj,
                            speed=speed)
        assert isinstance(res, ObjectiveGrids) and res.names == obj.names
        host = res.to_host()
        assert host.scalarized.shape == (len(fleets), len(xs))
        for name in obj.names:
            for si, fleet in enumerate(fleets):
                for pi, x in enumerate(xs):
                    want = OBJECTIVES[name].scalar(tg, fleet, x,
                                                   float(dq[si]), beta, cfg)
                    assert _approx(host[name][si, pi], want), (name, si, pi)
        stack = np.stack([host[n] for n in obj.names])
        np.testing.assert_allclose(
            host.scalarized, np.einsum("k,ksp->sp", obj.weights, stack),
            rtol=1e-6, atol=1e-6)
        want = obj.scalar_total(tg, fleets[0], xs[0], float(dq[0]), beta,
                                cfg)
        assert _approx(host.scalarized[0, 0], want)


@pytest.mark.parametrize("seed", range(4))
def test_single_scenario_broadcast(seed):
    """An S == 1 family / pack broadcasts its grids across the whole
    placement batch on both representations."""
    _, tg, fleets, _, xs, alpha = _instance(100 + seed)
    cfg = CostConfig(alpha=alpha)
    obj = ObjectiveSet.of(*ALL_OBJECTIVES)
    ev = BatchedEvaluator(tg, cfg, device="cpu")
    P = pack_placements(xs)
    for pack, speed in ((pack_region_fleets(fleets[:1]), None),
                        (pack_fleets(fleets[:1]), pack_speeds(fleets[:1]))):
        res = ev.score_grid(P, pack, dq=0.4, beta=0.6, objectives=obj,
                            speed=speed).to_host()
        for name in obj.names:
            assert res[name].shape == (1, len(xs))
            for pi, x in enumerate(xs):
                want = OBJECTIVES[name].scalar(tg, fleets[0], x, 0.4, 0.6,
                                               cfg)
                assert _approx(res[name][0, pi], want), (name, pi)


@pytest.mark.parametrize("seed", [0, 3, 5])
@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_grids_match_the_jax_package(seed, kind):
    """The port's score_grid(objectives=) against the JAX package's on the
    same graph, fleets, placements, dq and β."""
    g, tg, fleets, jfleets, xs, alpha = _instance(200 + seed)
    jobj = JaxSet.of(*ALL_OBJECTIVES, weights=WEIGHTS)
    obj = ObjectiveSet.of(*ALL_OBJECTIVES, weights=WEIGHTS)
    dq = np.linspace(0.2, 0.7, len(fleets))
    P = pack_placements(xs)
    if kind == "dense":
        jres = JaxEvaluator(g, JaxCfg(alpha=alpha)).score_grid(
            P, jax_pack_fleets(jfleets), dq=dq, beta=0.9, objectives=jobj,
            speed=jax_pack_speeds(jfleets))
        res = BatchedEvaluator(tg, CostConfig(alpha=alpha),
                               device="cpu").score_grid(
            P, pack_fleets(fleets), dq=dq, beta=0.9, objectives=obj,
            speed=pack_speeds(fleets))
    else:
        jfam = jax_pack_region(jfleets)
        fam = convert.region_family_from_arrays(
            jfam.region, jfam.inter, jfam.degrade, jfam.self_cost, jfam.speed)
        jres = JaxEvaluator(g, JaxCfg(alpha=alpha)).score_grid(
            P, jfam, dq=dq, beta=0.9, objectives=jobj)
        res = BatchedEvaluator(tg, CostConfig(alpha=alpha),
                               device="cpu").score_grid(
            P, fam, dq=dq, beta=0.9, objectives=obj)
    assert res.names == tuple(jres.names)
    for name in obj.names + ("scalarized",):
        got = (res.scalarized if name == "scalarized" else res[name]).numpy()
        want = np.asarray(jres.scalarized if name == "scalarized"
                          else jres[name], dtype=np.float64)
        np.testing.assert_allclose(got, want, rtol=REL, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_scalar_movement_matches_bruteforce(seed):
    """The port's factorized scalar network_movement (segment sums on
    RegionFleets) == the brute-force bilinear over the dense matrix."""
    _, tg, fleets, _, xs, _ = _instance(300 + seed)
    rates = tg.cumulative_rates()
    for fleet in fleets:
        com = fleet.com_matrix()
        ef = ExplicitFleet(com_cost=com)
        for weighted in (False, True):
            brute = 0.0
            for i, j in tg.edges:
                op = tg.operators[i]
                outer = np.outer(xs[0][i], xs[0][j])
                np.fill_diagonal(outer, 0.0)
                if weighted:
                    outer = outer * com
                brute += rates[i] * op.selectivity * op.out_bytes \
                    * outer.sum()
            for fl in (fleet, ef):
                assert network_movement(tg, fl, xs[0], weighted) \
                    == pytest.approx(brute, rel=1e-9, abs=1e-12)


def test_latency_f_spec_builders_match_oracle():
    """The latency_f spec's own dense and structured builders (score_grid
    carves latency_f out through the evaluator's kernel route instead)
    match the oracle, so the two routes cannot drift."""
    rng = np.random.default_rng(8)
    g = _payload_dag(rng, 5)
    tg = _port_graph(g)
    fleet = _region_fleets(rng, 6, 2)[0][1]
    x = random_placement(5, np.ones((5, 6), bool), rng, 0.3)
    cfg = CostConfig(alpha=0.5)
    spec = OBJECTIVES["latency_f"]
    dq, beta = 0.25, 0.6
    want = spec.scalar(tg, fleet, x, dq, beta, cfg)
    xt = torch.as_tensor(x, dtype=torch.float32)[None]
    ones = torch.ones(6)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    raw = spec.build_dense(tg, cfg, "cpu")(xt, f32(fleet.com_matrix()), ones)
    assert raw.shape == (1,)
    assert _approx(spec.finish(raw, dq, beta)[0], want)
    raw = spec.build_structured(tg, fleet.region, fleet.n_regions,
                                fleet.self_cost, cfg, "cpu")(
        xt, f32(fleet.inter), f32(fleet.degrade_or_ones()), ones)
    assert _approx(spec.finish(raw, dq, beta)[0], want)
    # the finish divides by the once-rounded float32 1 + β·dq
    denom = np.float32(np.float64(np.float32(beta)) * np.float64(
        np.float32(dq)) + 1.0)
    assert spec.finish(raw, dq, beta)[0].item() == np.float32(
        raw[0].numpy() / denom)


def test_occupancy_prices_degrade():
    """A straggler with a degrade multiplier occupies proportionally
    longer (effective speed = speed / degrade), in the oracle and in the
    structured twin, and degrade_device leaves the nominal speed alone."""
    rng = np.random.default_rng(5)
    tg = _port_graph(_payload_dag(rng, 4))
    fleet = RegionFleet(region=np.zeros(3, dtype=np.int64),
                        inter=np.ones((1, 1)))
    x = np.full((4, 3), 1 / 3)
    base = device_occupancy(tg, fleet, x)
    slow = fleet.degrade_device(1, 2.0)
    occ = device_occupancy(tg, slow, x)
    np.testing.assert_allclose(occ[1], 2.0 * base[1], rtol=1e-12)
    np.testing.assert_allclose(occ[[0, 2]], base[[0, 2]], rtol=1e-12)
    np.testing.assert_allclose(slow.speed, fleet.speed)
    ev = BatchedEvaluator(tg, device="cpu")
    fam = pack_region_fleets([fleet, slow])
    grid = ev.score_grid(x[None], fam, objectives="occupancy_max").to_host()
    np.testing.assert_allclose(grid["occupancy_max"][:, 0],
                               [base.max(), occ.max()], rtol=1e-6)


def test_score_grid_rejects_wronglength_dq():
    """dq must be a scalar or exactly (S,) on the multi-objective path
    too; scalar and exact (S,) still work."""
    rng = np.random.default_rng(2)
    tg = _port_graph(_payload_dag(rng, 3))
    fleets = _region_fleets(rng, 4, 3)[0]
    xs = pack_placements([random_placement(3, np.ones((3, 4), bool), rng)
                          for _ in range(5)])
    ev = BatchedEvaluator(tg, device="cpu")
    obj = ObjectiveSet.of(*ALL_OBJECTIVES)
    for pack in (pack_region_fleets(fleets), pack_fleets(fleets)):
        for bad in (np.array([0.1]), np.zeros(5), np.zeros((3, 1))):
            with pytest.raises(ValueError, match="scalar or shape"):
                ev.score_grid(xs, pack, dq=bad, objectives=obj)
        ev.score_grid(xs, pack, dq=0.2, objectives=obj)
        ev.score_grid(xs, pack, dq=np.full(3, 0.2), objectives=obj)


def test_objective_set_validation():
    with pytest.raises(ValueError, match="unknown objective"):
        ObjectiveSet.of("latency")
    with pytest.raises(ValueError, match="weights"):
        ObjectiveSet.of("latency_f", weights=[1.0, 2.0])
    with pytest.raises(ValueError, match="duplicate"):
        ObjectiveSet.of("latency_f", "latency_f")
    with pytest.raises(ValueError, match="at least one"):
        ObjectiveSet.of()
    s = ObjectiveSet.from_weights(latency_f=1.0, network_movement=0.05)
    assert s.names == ("latency_f", "network_movement")
    assert s.weights == (1.0, 0.05)
    assert hash(s) == hash(ObjectiveSet.from_weights(
        latency_f=1.0, network_movement=0.05))
    assert as_objective_set(s) is s
    assert as_objective_set("occupancy_max").names == ("occupancy_max",)
    assert as_objective_set(["latency_f", OBJECTIVES["network_movement"]]) \
        .names == ("latency_f", "network_movement")
    # speed is meaningless without objectives / on structured families
    rng = np.random.default_rng(4)
    tg = _port_graph(_payload_dag(rng, 3))
    fleets = _region_fleets(rng, 4, 2)[0]
    ev = BatchedEvaluator(tg, device="cpu")
    xs = pack_placements([random_placement(3, np.ones((3, 4), bool), rng)])
    with pytest.raises(ValueError, match="objectives"):
        ev.score_grid(xs, pack_fleets(fleets), speed=pack_speeds(fleets))
    with pytest.raises(ValueError, match="speeds"):
        ev.score_grid(xs, pack_region_fleets(fleets), speed=np.ones(4),
                      objectives=ObjectiveSet.of("occupancy_max"))
    with pytest.raises(ValueError, match=r"speed must be \(V,\) or \(S, V\)"):
        ev.score_grid(xs, pack_fleets(fleets), speed=np.ones(3),
                      objectives=ObjectiveSet.of("occupancy_max"))


def test_grids_come_back_in_declared_order_and_to_host_once():
    rng = np.random.default_rng(6)
    tg = _port_graph(_payload_dag(rng, 4))
    fleets = _region_fleets(rng, 5, 2)[0]
    xs = pack_placements([random_placement(4, np.ones((4, 5), bool), rng)
                          for _ in range(3)])
    order = ("occupancy_imbalance", "latency_f", "network_movement_cost")
    ev = BatchedEvaluator(tg, device="cpu")
    res = ev.score_grid(xs, pack_region_fleets(fleets),
                        objectives=ObjectiveSet.of(*order))
    assert res.names == order and tuple(res.grids) == order
    host = res.to_host()
    assert tuple(host.grids) == order
    for n in order:
        assert isinstance(host[n], np.ndarray) and host[n].dtype == np.float32
        np.testing.assert_array_equal(host[n], res[n].numpy())
    np.testing.assert_array_equal(host.scalarized, res.scalarized.numpy())
    # the latency_f grid of a set is the single-objective grid, bitwise
    np.testing.assert_array_equal(
        host["latency_f"], ev.score_grid(xs, pack_region_fleets(fleets))
        .numpy())


# -- the decision layer (mirror of tests/test_search.py) ---------------------

def _values(seed, k=3):
    rng = np.random.default_rng(seed)
    p = int(rng.integers(2, 40))
    return rng.uniform(0.0, 10.0, (p, k)), rng


def _dominates(a, b):
    return bool((a <= b).all() and (a < b).any())


@pytest.mark.parametrize("seed", range(6))
def test_pareto_front_matches_jax_and_is_non_dominated(seed):
    values, rng = _values(seed)
    front = dec.pareto_front(values)
    want = jdec.pareto_front(values)
    np.testing.assert_array_equal(front.indices, want.indices)
    np.testing.assert_array_equal(front.values, want.values)
    assert front.names == want.names and len(front) >= 1
    for a in range(len(front)):
        for b in range(len(front)):
            if a != b:
                assert not _dominates(front.values[a], front.values[b])
    for _ in range(8):     # every positive-weight argmin is on the front
        w = rng.uniform(0.05, 2.0, values.shape[1])
        k = int(np.argmin(dec.scalarize(values, w)))
        assert any(np.allclose(values[k], fv) for fv in front.values)


def test_pareto_mask_keeps_duplicates_and_drops_dominated():
    values = np.array([[1.0, 2.0], [1.0, 2.0], [2.0, 1.0], [2.0, 2.0],
                       [1.0, 3.0]])
    assert dec.pareto_mask(values).tolist() == [True, True, True, False,
                                                False]
    with pytest.raises(ValueError, match=r"\(P, K\)"):
        dec.pareto_mask(np.zeros(3))


@pytest.mark.parametrize("seed", range(4))
def test_normalized_selection_is_scale_invariant_and_matches_jax(seed):
    values, rng = _values(50 + seed)
    w = np.ones(values.shape[1])
    scales = dec.ObjectiveScales.fit(values)
    want = jdec.ObjectiveScales.fit(values)
    np.testing.assert_array_equal(scales.offset, want.offset)
    np.testing.assert_array_equal(scales.scale, want.scale)
    base = int(np.argmin(dec.scalarize(values, w, scales)))
    for col in range(values.shape[1]):
        scaled = values.copy()
        scaled[:, col] *= float(rng.uniform(0.01, 100.0))
        assert int(np.argmin(dec.scalarize(
            scaled, w, dec.ObjectiveScales.fit(scaled)))) == base


def test_normalization_edge_cases():
    normed = dec.ObjectiveScales.fit(
        np.array([[1.0, 5.0], [2.0, 5.0], [3.0, 5.0]]))
    np.testing.assert_allclose(
        normed.apply(np.array([[1.0, 5.0], [2.0, 5.0], [3.0, 5.0]])),
        [[0.0, 0.0], [0.5, 0.0], [1.0, 0.0]])
    scales = dec.ObjectiveScales.fit(
        np.array([[1.0, 2.0], [np.inf, 3.0], [3.0, 4.0]]))
    assert scales.offset[0] == 1.0 and scales.scale[0] == 2.0
    with pytest.raises(ValueError, match="empty"):
        dec.ObjectiveScales.fit(np.zeros((0, 2)))


@pytest.mark.parametrize("seed", range(6))
def test_epsilon_constraint_matches_jax(seed):
    """Uncapped ε-constraint is the plain argmin; capped, the winner is
    feasible and best among the feasible, infeasible rows hold +inf, and
    every answer equals the JAX package's."""
    values, _ = _values(80 + seed)
    for k in range(values.shape[1]):
        idx, scores = dec.epsilon_constraint(values, minimize=k)
        np.testing.assert_array_equal(scores, values[:, k])
        assert idx == int(np.argmin(values[:, k]))
    names = ("o0", "o1", "o2")
    cap = float(np.median(values[:, 1]))
    idx, scores = dec.epsilon_constraint(values, minimize="o0",
                                         caps={"o1": cap}, names=names)
    jidx, jscores = jdec.epsilon_constraint(values, minimize="o0",
                                            caps={"o1": cap}, names=names)
    assert idx == jidx
    np.testing.assert_array_equal(scores, jscores)
    feasible = values[:, 1] <= cap
    assert np.all(np.isinf(scores[~feasible]))
    assert feasible[idx] and scores[idx] == values[feasible, 0].min()


def test_epsilon_constraint_validates_inputs():
    v = np.arange(6.0).reshape(3, 2)
    names = ("a", "b")
    with pytest.raises(ValueError, match="not among"):
        dec.epsilon_constraint(v, minimize="zzz", names=names)
    with pytest.raises(ValueError, match="unknown objectives"):
        dec.epsilon_constraint(v, minimize="a", caps={"zzz": 1.0},
                               names=names)
    with pytest.raises(ValueError, match="cannot cap the minimized"):
        dec.epsilon_constraint(v, minimize="a", caps={"a": 1.0}, names=names)
    with pytest.raises(ValueError, match="out of range"):
        dec.epsilon_constraint(v, minimize=2)


def test_front_and_epsilon_from_one_score_grid_match_jax():
    """Pareto and ε-constraint over the port's ObjectiveGrids (one dense
    score_grid) == the JAX decision layer over the JAX grids; an
    impossible cap reports all-+inf scores instead of raising."""
    rng = np.random.default_rng(7)
    g = _payload_dag(rng, 5)
    tg = _port_graph(g)
    coms = []
    for _ in range(3):
        com = rng.uniform(0.1, 2.0, (4, 4))
        com = (com + com.T) / 2
        np.fill_diagonal(com, 0.0)
        coms.append(com)
    xs = pack_placements([random_placement(5, np.ones((5, 4), bool), rng,
                                           0.3) for _ in range(32)])
    obj3 = ("latency_f", "network_movement", "occupancy_max")
    pack = np.stack(coms).astype(np.float32)
    grids = BatchedEvaluator(tg, device="cpu").score_grid(
        xs, pack, dq=0.3, beta=0.5, objectives=ObjectiveSet.of(*obj3)) \
        .to_host()
    jgrids = JaxEvaluator(g).score_grid(xs, pack, dq=0.3, beta=0.5,
                                        objectives=JaxSet.of(*obj3))
    np.testing.assert_allclose(dec.candidate_values(grids),
                               jdec.candidate_values(jgrids), rtol=REL,
                               atol=1e-6)
    front = dec.pareto_front(grids, scenario="worst")
    assert front.names == obj3
    np.testing.assert_array_equal(front.indices,
                                  jdec.pareto_front(jgrids).indices)
    for scenario in ("worst", 1):
        cap = float(np.median(dec.candidate_values(grids, scenario)[:, 1]))
        idx, scores = dec.epsilon_constraint(
            grids, "latency_f", {"network_movement": cap}, scenario=scenario)
        jidx, _ = jdec.epsilon_constraint(
            jgrids, "latency_f", {"network_movement": cap},
            scenario=scenario)
        assert idx == jidx and np.isfinite(scores[idx])
    _, scores = dec.epsilon_constraint(grids, "latency_f",
                                       {"network_movement": -1.0})
    assert np.all(np.isinf(scores))
