"""The port's ``BatchedEvaluator`` (``device="cpu"``, the plain versions)
against ``repro.sim.BatchedEvaluator`` and the float64 oracle, on dense
(S, V, V) packs and on ``RegionFleetFamily`` packs.

Inputs are made with numpy from a seed and cross over as arrays /
``repro_torch.convert``.  Tolerance ≤1e-5 relative: float32 sums in
different orders on the two sides; the inter/degrade factors are cast to
float32 before the region factors on both sides."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import (CostConfig, ExplicitFleet, RegionFleet,  # noqa: E402
                        latency, objective_F, random_dag, random_placement)
from repro.sim import BatchedEvaluator as JaxEvaluator  # noqa: E402
from repro.sim import pack_fleets as jax_pack_fleets  # noqa: E402
from repro.sim import pack_region_fleets as jax_pack_region  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import CostConfig as PortCostConfig  # noqa: E402
from repro_torch.sim import BatchedEvaluator, fresh_cache  # noqa: E402

REL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _port_graph(g):
    ops = g.operators
    return convert.graph_from_arrays(
        [o.name for o in ops], [o.selectivity for o in ops],
        [o.out_bytes for o in ops], [o.work for o in ops],
        [o.dq_eligible for o in ops], g.edges)


def _setup(seed, n_ops=6, V=10, P=5, S=3):
    rng = np.random.default_rng(seed)
    g = random_dag(n_ops, edge_prob=0.5, rng=rng)
    dense = []
    for _ in range(S):
        c = rng.uniform(0.1, 3.0, (V, V))
        np.fill_diagonal(c, 0.0)
        dense.append(ExplicitFleet(com_cost=c))
    R = 3
    region = rng.integers(0, R, V)
    structured = []
    for k in range(S):
        inter = rng.uniform(0.1, 2.0, (R, R))
        structured.append(RegionFleet(
            region=region, inter=(inter + inter.T) / 2, self_cost=0.02,
            degrade=None if k == 0 else rng.uniform(1.0, 3.0, V)))
    avail = np.ones((n_ops, V), bool)
    xs = np.stack([random_placement(n_ops, avail, rng, 0.3)
                   for _ in range(P)]).astype(np.float32)
    return g, dense, structured, xs


def _packs(dense, structured):
    coms = np.array(jax_pack_fleets(dense))
    fam = jax_pack_region(structured)
    port_fam = convert.region_family_from_arrays(
        fam.region, fam.inter, fam.degrade, fam.self_cost, fam.speed)
    return coms, fam, convert.dense_pack_from_array(coms), port_fam


@pytest.mark.parametrize("kind", ["dense", "structured"])
@pytest.mark.parametrize("alpha", [0.0, 0.2])
def test_score_grid_matches_jax_and_oracle(kind, alpha):
    g, dense, structured, xs = _setup(3)
    coms, fam, port_coms, port_fam = _packs(dense, structured)
    S = coms.shape[0]
    dq = np.linspace(0.1, 0.9, S)
    cfg = CostConfig(alpha=alpha)
    jax_pack, port_pack = (coms, port_coms) if kind == "dense" \
        else (fam, port_fam)
    want = np.asarray(JaxEvaluator(g, cfg).score_grid(xs, jax_pack, dq=dq,
                                                      beta=0.6))
    ev = BatchedEvaluator(_port_graph(g), PortCostConfig(alpha=alpha),
                          device="cpu")
    got = ev.score_grid(xs, port_pack, dq=dq, beta=0.6)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == (S, xs.shape[0])
    assert _rel(got.numpy(), want) <= REL
    fleets = dense if kind == "dense" else structured
    oracle = np.array([[objective_F(latency(g, f, x.astype(np.float64),
                                            cfg), dq[s], 0.6)
                        for x in xs] for s, f in enumerate(fleets)])
    assert _rel(got.numpy(), oracle) <= REL


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_batched_entry_points_match_jax(kind):
    """edge_latencies / latency / objective on a B-batch against one shared
    scenario (com batch 1, family of 1)."""
    g, dense, structured, xs = _setup(4)
    coms, fam, port_coms, port_fam = _packs(dense, structured)
    if kind == "dense":
        jp, pp = coms[:1], port_coms[:1]
    else:
        jp = jax_pack_region(structured[1:2])
        pp = convert.region_family_from_arrays(
            jp.region, jp.inter, jp.degrade, jp.self_cost, jp.speed)
    jev = JaxEvaluator(g)
    ev = BatchedEvaluator(_port_graph(g), device="cpu")
    assert _rel(ev.edge_latencies(xs, pp).numpy(),
                np.asarray(jev.edge_latencies(xs, jp))) <= REL
    assert _rel(ev.latency(xs, pp).numpy(),
                np.asarray(jev.latency(xs, jp))) <= REL
    assert _rel(ev.objective(xs, pp, dq=0.4, beta=1.5).numpy(),
                np.asarray(jev.objective(xs, jp, dq=0.4, beta=1.5))) <= REL


def test_per_scenario_com_batch_matches_pairwise():
    """A (B, V, V) com batch scores row b against com b (Bc = B route)."""
    g, dense, _, xs = _setup(5, P=3, S=3)
    coms = np.array(jax_pack_fleets(dense))
    ev = BatchedEvaluator(_port_graph(g), device="cpu")
    got = ev.latency(xs, coms).numpy()
    want = [latency(g, dense[b], xs[b].astype(np.float64)) for b in range(3)]
    assert _rel(got, want) <= REL


def test_score_grid_validation_and_unported_options():
    g, dense, structured, xs = _setup(6)
    coms = np.array(jax_pack_fleets(dense))
    fam = _packs(dense, structured)[3]
    ev = BatchedEvaluator(_port_graph(g), device="cpu")
    with pytest.raises(ValueError, match="dq must be a scalar"):
        ev.score_grid(xs, coms, dq=np.zeros(1 + coms.shape[0]))
    # the reference's validation of the multi-objective surface: speed
    # feeds only the occupancy objectives, and only on dense packs
    with pytest.raises(ValueError, match="pass objectives= to use it"):
        ev.score_grid(xs, coms, speed=np.ones(coms.shape[1]))
    with pytest.raises(ValueError, match="carry their own speeds"):
        ev.score_grid(xs, fam, speed=np.ones(fam.n_devices),
                      objectives=("occupancy_max",))
    with pytest.raises(NotImplementedError):
        BatchedEvaluator(_port_graph(g),
                         PortCostConfig(include_compute=True), device="cpu")


def test_score_grid_is_deterministic_and_dq_finish_is_single_rounded():
    """Two calls are bitwise equal, and the dq/β finish divides the raw
    grid by the once-rounded float32 ``1 + β·dq``."""
    g, dense, structured, xs = _setup(7)
    _, _, port_coms, port_fam = _packs(dense, structured)
    ev = BatchedEvaluator(_port_graph(g), device="cpu")
    for pack in (port_coms, port_fam):
        a = ev.score_grid(xs, pack, dq=0.3, beta=0.7)
        assert torch.equal(a, ev.score_grid(xs, pack, dq=0.3, beta=0.7))
        raw = ev.score_grid(xs, pack).numpy()
        denom = np.float32(np.float64(np.float32(0.7))
                           * np.float64(np.float32(0.3)) + 1.0)
        np.testing.assert_array_equal(a.numpy(), raw / denom)


def test_shared_evaluator_is_one_instance_per_content():
    g, _, _, _ = _setup(8)
    with fresh_cache():
        a = BatchedEvaluator.shared(_port_graph(g), device="cpu")
        b = BatchedEvaluator.shared(_port_graph(g), device="cpu")
        assert a is b
        assert BatchedEvaluator.shared(_port_graph(g), PortCostConfig(
            alpha=0.1), device="cpu") is not a
