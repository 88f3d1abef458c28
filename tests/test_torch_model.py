"""``repro_torch.core.torchmodel`` against ``repro.core.jaxmodel`` and the
float64 oracle: dense (ExplicitFleet) and structured (RegionFleet) edge
latencies with ``alpha`` 0 and > 0, and the critical-path DP.

The graph and fleets cross over through ``repro_torch.convert``; inputs are
made with numpy from a seed.  Tolerance ≤1e-5 relative: float32 sums in
different orders on the two sides."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import (ExplicitFleet, RegionFleet, edge_latencies,  # noqa: E402
                        latency, random_dag, random_placement)
from repro.core.jaxmodel import (SmoothConfig, critical_path_dp,  # noqa: E402
                                 make_edge_latencies_com_fn,
                                 make_edge_latencies_region_fn)
from repro.core.costmodel import CostConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import devices as tdev  # noqa: E402
from repro_torch.core import torchmodel as tm  # noqa: E402

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


def _instance(seed, n_ops=6, V=11, P=4, sparsity=0.4):
    rng = np.random.default_rng(seed)
    g = random_dag(n_ops, edge_prob=0.5, rng=rng)
    avail = np.ones((n_ops, V), bool)
    xs = np.stack([random_placement(n_ops, avail, rng, sparsity)
                   for _ in range(P)]).astype(np.float32)
    return rng, g, xs


@pytest.mark.parametrize("alpha", [0.0, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_edge_latencies_match_jax_and_oracle(alpha, seed):
    rng, g, xs = _instance(seed)
    V = xs.shape[2]
    com = rng.uniform(0.1, 3.0, (V, V))
    np.fill_diagonal(com, 0.0)
    com32 = com.astype(np.float32)
    jfn = make_edge_latencies_com_fn(g, SmoothConfig(alpha=alpha),
                                     nz_eps=1e-3)
    want = np.asarray(jax.vmap(jfn, in_axes=(0, None))(jnp.asarray(xs),
                                                       jnp.asarray(com32)))
    tfn = tm.make_edge_latencies_com_fn(_port_graph(g), alpha=alpha,
                                        nz_eps=1e-3, device="cpu")
    got = tfn(torch.from_numpy(xs), torch.from_numpy(com32[None])).numpy()
    assert got.shape == (xs.shape[0], g.n_edges)
    assert _rel(got, want) <= REL
    cfg = CostConfig(alpha=alpha, nz_eps=1e-3)
    fleet = ExplicitFleet(com_cost=com32.astype(np.float64))
    oracle = np.stack([edge_latencies(g, fleet, x.astype(np.float64), cfg)
                       for x in xs])
    assert _rel(got, oracle) <= REL


@pytest.mark.parametrize("alpha", [0.0, 0.3])
@pytest.mark.parametrize("degraded", [False, True])
def test_structured_edge_latencies_match_jax_and_oracle(alpha, degraded):
    rng, g, xs = _instance(7 + degraded)
    V = xs.shape[2]
    R = 3
    region = rng.integers(0, R, V)
    inter = rng.uniform(0.1, 2.0, (R, R))
    inter = (inter + inter.T) / 2
    degrade = rng.uniform(1.0, 3.0, V) if degraded else np.ones(V)
    self_cost = 0.05
    inter32 = inter.astype(np.float32)
    deg32 = degrade.astype(np.float32)
    jfn = make_edge_latencies_region_fn(g, region, R, self_cost,
                                        SmoothConfig(alpha=alpha),
                                        nz_eps=1e-3)
    want = np.asarray(jax.vmap(jfn, in_axes=(0, None, None))(
        jnp.asarray(xs), jnp.asarray(inter32), jnp.asarray(deg32)))
    tfn = tm.make_edge_latencies_region_fn(_port_graph(g), region, R,
                                           self_cost, alpha=alpha,
                                           nz_eps=1e-3, device="cpu")
    got = tfn(torch.from_numpy(xs), torch.from_numpy(inter32[None]),
              torch.from_numpy(deg32[None])).numpy()
    assert _rel(got, want) <= REL
    fleet = RegionFleet(region=region, inter=inter32.astype(np.float64),
                        self_cost=self_cost,
                        degrade=deg32.astype(np.float64))
    cfg = CostConfig(alpha=alpha, nz_eps=1e-3)
    oracle = np.stack([edge_latencies(g, fleet, x.astype(np.float64), cfg)
                       for x in xs])
    assert _rel(got, oracle) <= REL


def test_region_mass_is_the_scatter_sum():
    """The one-hot product equals the reference's segment sum of
    degrade·x_j, and two calls are bitwise equal."""
    rng = np.random.default_rng(3)
    V, R = 23, 4
    region = rng.integers(0, R, V)
    xj = rng.random((2, 5, V)).astype(np.float32)
    deg = rng.uniform(1, 2, (1, V)).astype(np.float32)
    want = np.zeros((2, 5, R))
    np.add.at(want, (slice(None), slice(None), region),
              (deg[0] * xj).astype(np.float64))
    onehot = tm.region_onehot(torch.as_tensor(region), R)
    got = tm.region_mass(torch.from_numpy(xj), torch.from_numpy(deg), onehot)
    assert _rel(got.numpy(), want) <= REL
    assert torch.equal(got, tm.region_mass(torch.from_numpy(xj),
                                           torch.from_numpy(deg), onehot))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critical_path_dp_matches_jax_and_oracle(seed):
    rng, g, xs = _instance(seed, n_ops=7)
    elat = rng.uniform(0.0, 5.0, (3, 4, g.n_edges)).astype(np.float32)
    want = np.asarray(critical_path_dp(g, jnp.asarray(elat)))
    got = tm.critical_path_dp(_port_graph(g), torch.from_numpy(elat))
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), want)   # max and + only
    # through the oracle: DP over one placement's edge latencies
    V = xs.shape[2]
    com = rng.uniform(0.1, 3.0, (V, V))
    fleet = ExplicitFleet(com_cost=com)
    for x in xs:
        el = edge_latencies(g, fleet, x.astype(np.float64))
        lat = tm.critical_path_dp(_port_graph(g),
                                  torch.from_numpy(el[None]))[0]
        assert abs(float(lat) - latency(g, fleet, x)) <= \
            REL * max(latency(g, fleet, x), 1e-12)


def test_port_oracle_is_the_reference_oracle():
    """The copied float64 oracle prices a RegionFleet exactly as the
    reference does (same code, no jax involved)."""
    rng, g, xs = _instance(5)
    V = xs.shape[2]
    region = rng.integers(0, 2, V)
    inter = rng.uniform(0.1, 2.0, (2, 2))
    deg = rng.uniform(1, 2, V)
    ref_fleet = RegionFleet(region=region, inter=inter, degrade=deg)
    port_fleet = tdev.RegionFleet(region=region, inter=inter, degrade=deg)
    tg = _port_graph(g)
    for x in xs.astype(np.float64):
        assert tcost.latency(tg, port_fleet, x) == latency(g, ref_fleet, x)


def test_edge_latency_builders_default_to_the_card(monkeypatch):
    """The public builders resolve ``device=None`` to the card, as every
    entry point does: without CUDA they raise unless the caller passes
    ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g, xs = _instance(9)
    tg = _port_graph(g)
    region = np.zeros(xs.shape[2], dtype=np.int64)
    for make in (lambda **k: tm.make_edge_latencies_com_fn(tg, **k),
                 lambda **k: tm.make_edge_latencies_region_fn(
                     tg, region, 1, **k)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(device="cuda")
        make(device="cpu")
