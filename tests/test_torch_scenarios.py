"""The port's copied generators (``repro_torch.sim.scenarios``) and
candidate sources (``repro_torch.search.candidates``) against the JAX
package's, bitwise, on the same seeds.

Both are numpy: every fleet, graph, trace, scenario and candidate batch
must be equal field for field (arrays with equal dtype, shape and bits),
and each generator must leave the rng in the same state, so a seed drives
the two packages through the same stream.
"""

import dataclasses

import numpy as np
import pytest

import repro.search.candidates as jc
import repro.sim.scenarios as js
import repro_torch.search.candidates as tc
import repro_torch.sim.scenarios as ts
from repro.core.devices import RegionFleet as JaxRegionFleet
from repro_torch.core.devices import RegionFleet

SEEDS = [0, 1, 7]


def _assert_same(a, b, path="value"):
    """Field-for-field equality across the two packages' types."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif hasattr(a, "operators"):                       # OpGraph
        assert type(b).__name__ == "OpGraph", path
        _assert_same(a.operators, b.operators, f"{path}.operators")
        assert a.edges == b.edges and a.topo_order == b.topo_order, path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{k}]")
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def _both(fn_j, fn_t, seed):
    """Run the JAX package's and the port's generator on one seed each;
    the results and the rng states after them must be equal."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    a, b = fn_j(rj), fn_t(rt)
    _assert_same(a, b)
    assert rj.bit_generator.state == rt.bit_generator.state
    return a, b


def _cfg(mod, **kw):
    return mod.ScenarioConfig(**kw)


def test_constants_match():
    assert ts.MIN_ALIVE_DEVICES == js.MIN_ALIVE_DEVICES
    assert ts.GRAPH_FAMILIES == js.GRAPH_FAMILIES
    _assert_same(js.ScenarioConfig(), ts.ScenarioConfig())
    assert ts.__all__ == js.__all__


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("n_devices", [None, 13])
def test_random_fleet_bitwise(seed, explicit, n_devices):
    _both(lambda r: js.random_fleet(r, _cfg(js, explicit_fleet=explicit),
                                    n_devices=n_devices),
          lambda r: ts.random_fleet(r, _cfg(ts, explicit_fleet=explicit),
                                    n_devices=n_devices), seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_perturbed_fleet_bitwise(seed):
    base_j = js.random_fleet(np.random.default_rng(99), n_devices=9)
    base_t = ts.random_fleet(np.random.default_rng(99), n_devices=9)
    base_j, base_t = base_j.degrade_device(2, 3.0), base_t.degrade_device(2, 3.0)
    _both(lambda r: js.perturbed_fleet(base_j, r, jitter=0.4),
          lambda r: ts.perturbed_fleet(base_t, r, jitter=0.4), seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_base", [False, True])
def test_region_fleet_family_bitwise(seed, with_base):
    kw = dict(straggler_prob=0.2, outage_prob=0.3)
    region = np.repeat(np.arange(3), [3, 4, 2])
    inter = np.array([[0.1, 2.0, 3.0], [2.0, 0.1, 1.0], [3.0, 1.0, 0.1]])
    base_j = JaxRegionFleet(region=region, inter=inter, self_cost=0.05,
                            speed=np.linspace(0.5, 2.0, 9)
                            ).degrade_device(4, 3.0) if with_base else None
    base_t = RegionFleet(region=region, inter=inter, self_cost=0.05,
                         speed=np.linspace(0.5, 2.0, 9)
                         ).degrade_device(4, 3.0) if with_base else None
    _both(lambda r: js.region_fleet_family(r, 5, _cfg(js, **kw),
                                           n_devices=40, base=base_j),
          lambda r: ts.region_fleet_family(r, 5, _cfg(ts, **kw),
                                           n_devices=40, base=base_t), seed)


@pytest.mark.parametrize("family", list(js.GRAPH_FAMILIES) + [None])
def test_random_graph_bitwise(family):
    for seed in SEEDS:
        _both(lambda r: js.random_graph(r, family=family),
              lambda r: ts.random_graph(r, family=family), seed)


def test_random_graph_unknown_family_raises_alike():
    for mod in (js, ts):
        with pytest.raises(ValueError, match="unknown graph family"):
            mod.random_graph(np.random.default_rng(0), family="star")


def test_diurnal_rate_bitwise():
    for t in range(30):
        assert ts.diurnal_rate(t, ts.ScenarioConfig(), 0.3) == \
            js.diurnal_rate(t, js.ScenarioConfig(), 0.3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("realism", [False, True])
def test_random_trace_bitwise(seed, realism):
    """Plain traces and traces with Markov region outages and selectivity
    drift; degrade/loss rates raised so fleet events occur."""
    kw = dict(trace_len=64, degrade_prob=0.15, loss_prob=0.1)
    if realism:
        kw.update(outage_on_prob=0.1, selectivity_drift_std=0.3)
    a, _ = _both(lambda r: js.random_trace(r, 9, _cfg(js, **kw),
                                           n_regions=3, n_ops=5),
                 lambda r: ts.random_trace(r, 9, _cfg(ts, **kw),
                                           n_regions=3, n_ops=5), seed)
    kinds = {e.kind for e in a}
    assert {"degrade", "remove"} <= kinds
    if realism:
        assert {"outage", "recover", "drift"} <= kinds


@pytest.mark.parametrize("seed", SEEDS)
def test_random_scenario_bitwise(seed):
    _both(lambda r: js.random_scenario(r, name="s"),
          lambda r: ts.random_scenario(r, name="s"), seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_devices", [None, 11])
def test_scenario_batch_bitwise(seed, n_devices):
    kw = dict(trace_len=12, outage_on_prob=0.05, selectivity_drift_std=0.2)
    _both(lambda r: js.scenario_batch(r, 3, _cfg(js, **kw),
                                      n_devices=n_devices),
          lambda r: ts.scenario_batch(r, 3, _cfg(ts, **kw),
                                      n_devices=n_devices), seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_region_scenario_batch_bitwise(seed):
    """The robust_structured phase's generator at a small V (its own graph
    from random_dag, eight regions, default stragglers)."""
    from repro.core.graph import random_dag as jdag
    from repro_torch.core.graph import random_dag as tdag
    gj = jdag(12, 0.3, np.random.default_rng(5))
    gt = tdag(12, 0.3, np.random.default_rng(5))
    _assert_same(gj, gt)
    a, _ = _both(
        lambda r: js.region_scenario_batch(
            r, 4, js.ScenarioConfig(n_regions=(8, 8)), graph=gj,
            n_devices=256),
        lambda r: ts.region_scenario_batch(
            r, 4, ts.ScenarioConfig(n_regions=(8, 8)), graph=gt,
            n_devices=256), seed)
    assert all(isinstance(s.fleet, JaxRegionFleet) for s in a)


# -- candidate sources ---------------------------------------------------------

def _avail(n_ops=3, v=4, seed=3):
    a = np.random.default_rng(seed).random((n_ops, v)) < 0.8
    a[:, 0] = True
    return a


@pytest.mark.parametrize("include", [(), (0.37,), (1.4, -0.2, 0.6)])
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_dq_grid_bitwise_with_incumbent(beta, include):
    got = tc.dq_grid(beta, steps=5, include=include)
    want = jc.dq_grid(beta, steps=5, include=include)
    _assert_same(want, got)
    for v in include:
        assert float(np.clip(v, 0, 1)) in got


@pytest.mark.parametrize("granularity", [2, 3])
def test_grid_placements_bitwise(granularity):
    avail = _avail()
    assert tc.count_grid_states(avail, granularity) == \
        jc.count_grid_states(avail, granularity)
    want = list(jc.chunked(jc.grid_placements(avail, granularity), 7))
    got = list(tc.chunked(tc.grid_placements(avail, granularity), 7))
    _assert_same(want, got)
    assert sum(len(c) for c in got) == tc.count_grid_states(avail,
                                                            granularity)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sparsity", [0.0, 0.5])
def test_random_placements_bitwise(seed, sparsity):
    avail = _avail(4, 9)
    _both(lambda r: jc.random_placements(avail, r, 6, sparsity),
          lambda r: tc.random_placements(avail, r, 6, sparsity), seed)


@pytest.mark.parametrize("op,delta", [(0, 0.1), (1, 0.05), (2, 0.4)])
def test_transfer_neighborhood_bitwise(op, delta):
    avail = _avail(3, 5)
    x = tc.random_placements(avail, np.random.default_rng(8), 1)[0]
    _assert_same(jc.transfer_neighborhood(x, avail, op, delta),
                 tc.transfer_neighborhood(x, avail, op, delta))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_anneal_path_bitwise(seed, beta):
    avail = _avail(3, 5)
    x = tc.random_placements(avail, np.random.default_rng(8), 1)[0]
    _both(lambda r: jc.anneal_path(x, 0.3, avail, r, 40, beta),
          lambda r: tc.anneal_path(x, 0.3, avail, r, 40, beta), seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 9])
def test_incumbent_candidates_bitwise(seed, n):
    avail = _avail(3, 6)
    x = tc.random_placements(avail, np.random.default_rng(4), 1)[0]
    a, _ = _both(lambda r: jc.incumbent_candidates(x, avail, r, n),
                 lambda r: tc.incumbent_candidates(x, avail, r, n), seed)
    assert np.array_equal(a[0], x)


@pytest.mark.parametrize("epsilon,top_k", [(0.2, 1), (0.3, 3), (0.0, 2)])
def test_probe_candidates_bitwise(epsilon, top_k):
    avail = _avail(3, 6)
    x = tc.random_placements(avail, np.random.default_rng(4), 1)[0]
    std = np.array([0.1, 0.5, 0.0, 0.5, 0.2, 0.05])
    _assert_same(jc.probe_candidates(x, avail, std, epsilon, top_k),
                 tc.probe_candidates(x, avail, std, epsilon, top_k))
