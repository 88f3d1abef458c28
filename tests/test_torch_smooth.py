"""The port's smoothed cost model and ``projected_gradient`` (ROADMAP A9)
against the JAX package, on the CPU.

Inputs are made with numpy from seeds and handed to both packages.  Bars:

* the smoothed latency / objective and its gradient: ≤1e-5 relative
  (max |err| / max |want|) to the JAX function and ``jax.grad``, both in
  float32; at temp 0 the value also ≤1e-5 to the float64 oracle.  The
  port writes logsumexp as JAX does, so its gradient carries JAX's
  roundings (measured ≤1e-7 here).
* ``projected_gradient`` from the start logits the reference draws
  (``z0``): the loss history step for step within 1e-5 absolute, the
  same ``dq_fraction``, x within 1e-5 and F within 1e-6 relative, where
  float32 determines the trajectory.  A step is ulp-level apart (torch's
  and XLA's ``exp`` and fused sums round differently; the reference's
  jitted and eager runs differ likewise), and Adam amplifies: its first
  step after each temperature's restart is ±lr per coordinate whatever
  the gradient's size.  On the paper problem (quickstart's 150 steps × 3
  temperatures) the reference's jitted and eager runs are 5.2e-6 apart;
  on a stiff random problem they part by 2e-2 to 6e-2, and there the
  port is held within the reference's own spread (ROADMAP Queue C).
* on the port's own draw (a ``torch.Generator``, not ``jax.random``):
  only the invariants — rows on the simplex, availability kept, F at most
  the uniform placement's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import jaxmodel  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import torchmodel  # noqa: E402

CPU = "cpu"
TEMPS = [0.0, 0.1, 0.02, 0.005]
COM = np.array([[0.0, 1.5, 2.0], [1.5, 0.0, 1.0], [2.0, 1.0, 0.0]])


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fleets(kind, V, seed):
    """The same random fleet in both packages: a dense symmetric com
    matrix, or 3 regions with degraded devices and a self cost."""
    rng = np.random.default_rng(seed)
    if kind == "explicit":
        com = rng.uniform(0.2, 3.0, (V, V))
        com = (com + com.T) / 2
        np.fill_diagonal(com, 0.0)
        return J.ExplicitFleet(com_cost=com), T.ExplicitFleet(com_cost=com)
    region = rng.integers(0, 3, V)
    inter = rng.uniform(0.5, 4.0, (3, 3))
    inter = (inter + inter.T) / 2
    degrade = np.where(rng.random(V) < 0.3, 2.5, 1.0)
    kw = dict(region=region, inter=inter, self_cost=0.05, degrade=degrade)
    return J.RegionFleet(**kw), T.RegionFleet(**kw)


def _graphs(seed, n_ops=6):
    return (J.random_dag(n_ops, 0.5, np.random.default_rng(seed)),
            T.random_dag(n_ops, 0.5, np.random.default_rng(seed)))


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("alpha", [0.0, 0.05])
@pytest.mark.parametrize("kind", ["explicit", "region"])
def test_objective_and_gradient_match_jax(kind, alpha, temp):
    gj, gt = _graphs(3)
    fj, ft = _fleets(kind, 9, 4)
    beta = 0.8
    obj_j = jaxmodel.make_objective_fn(
        gj, fj, beta, jaxmodel.SmoothConfig(alpha=alpha, temp=temp))
    obj_t = torchmodel.make_objective_fn(
        gt, ft, beta, torchmodel.SmoothConfig(alpha=alpha, temp=temp),
        device=CPU)
    rng = np.random.default_rng(5)
    for _ in range(4):
        z = rng.standard_normal((gt.n_ops, 9)).astype(np.float32) * 1.5
        x = np.asarray(jax.nn.softmax(jnp.asarray(z), axis=1))
        dq = np.float32(rng.uniform())
        (vj, (gxj, gdj)) = jax.value_and_grad(obj_j, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(dq))
        xt = torch.tensor(x, requires_grad=True)
        dqt = torch.tensor(dq, requires_grad=True)
        vt = obj_t(xt, dqt)
        gxt, gdt = torch.autograd.grad(vt, (xt, dqt))
        assert vt.dtype == torch.float32 and vt.shape == ()
        assert _rel(vt.detach(), vj) <= 1e-5
        assert _rel(gxt, gxj) <= 1e-5
        assert _rel(gdt, gdj) <= 1e-5
        if temp == 0.0:   # hard mode is the paper's model
            lat = T.latency(gt, ft, x.astype(np.float64),
                            T.CostConfig(alpha=alpha))
            want = T.objective_F(lat, float(dq), beta)
            assert abs(float(vt.detach()) - want) <= 1e-5 * abs(want)


def test_smooth_cfg_carries_alpha_only():
    from repro_torch.core.objectives import _smooth_cfg
    assert _smooth_cfg(T.CostConfig(alpha=0.3, nz_eps=0.1)) == \
        T.SmoothConfig(alpha=0.3)


# -- projected_gradient -------------------------------------------------------

def _paper(mod):
    return mod.PlacementProblem(
        mod.linear_graph([1.0, 1.5, 1.0]), mod.ExplicitFleet(com_cost=COM),
        beta=1.0, dq=mod.DQCoupling(cap0=np.full(3, 1.2),
                                    load=np.full(3, 0.2)))


def _random_problem(mod, kind, seed):
    """A random DAG on a random fleet of 7 devices with α > 0, some
    placements forbidden and a capacity coupling."""
    rng = np.random.default_rng(seed)
    g = mod.random_dag(5, 0.5, np.random.default_rng(seed))
    fj, ft = _fleets(kind, 7, seed)
    avail = rng.random((5, 7)) < 0.75
    avail[:, 0] = True
    fleet = fj if mod is J else ft
    fleet.available = avail
    return mod.PlacementProblem(
        g, fleet, cost_cfg=mod.CostConfig(alpha=0.02), beta=0.6,
        dq=mod.DQCoupling(cap0=np.full(7, 1.4), load=np.full(7, 0.3)))


PROBLEMS = {"paper": _paper,
            "random_explicit": lambda m: _random_problem(m, "explicit", 11),
            "random_region": lambda m: _random_problem(m, "region", 12)}


def _jax_start(prob, seed=0):
    n_ops, n_dev = prob.availability().shape
    return np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(seed),
                                               (n_ops, n_dev)))


# (problem, steps, temperatures) whose trajectory float32 determines: the
# reference's jitted and eager runs agree there within the bars below
DETERMINED = [("paper", 150, (0.1, 0.02, 0.005)),
              ("random_region", 150, (0.1,))]


@pytest.mark.parametrize("name,steps,temps", DETERMINED)
def test_projected_gradient_from_the_jax_start_matches_jax(name, steps,
                                                           temps):
    pj, pt = PROBLEMS[name](J), PROBLEMS[name](T)
    want = J.projected_gradient(pj, steps=steps, temps=temps)
    got = T.projected_gradient(pt, steps=steps, temps=temps, device=CPU,
                               z0=_jax_start(pj))
    assert len(got.history) == len(want.history) == steps * len(temps)
    assert np.abs(np.array(got.history) - np.array(want.history)).max() \
        <= 1e-5
    assert got.dq_fraction == want.dq_fraction
    assert np.abs(got.x - want.x).max() <= 1e-5
    assert abs(got.F - want.F) <= 1e-6 * abs(want.F)
    assert (got.evals, got.dispatches) == (want.evals, want.dispatches)


# the reference against itself on the stiff problem (80 steps × 3
# temperatures), jitted vs under jax.disable_jit() on jax 0.9.0 (the eager
# run takes ~2 min, so it is not repeated here): loss history 6.48e-2
# apart (at step 81, the second temperature's restart), F 1.10e-3
# relative, x 4.71e-2, the same dq
STIFF_SPREAD = dict(history=6.48e-2, F=1.10e-3)


def test_a_stiff_trajectory_is_held_within_the_references_own_spread():
    """On the random dense problem (α 0.02: the soft link indicator's slope
    reaches 1/link_eps near x = 0) float32 does not determine the
    trajectory: the reference's own jitted and eager runs part by
    ``STIFF_SPREAD``, because XLA's fusions round differently and Adam
    turns each ulp into ±lr at a temperature's restart.  So the port is
    held within twice that spread, with the same dq."""
    pj, pt = PROBLEMS["random_explicit"](J), PROBLEMS["random_explicit"](T)
    want = J.projected_gradient(pj, steps=80)
    got = T.projected_gradient(pt, steps=80, device=CPU, z0=_jax_start(pj))
    assert got.dq_fraction == want.dq_fraction
    assert abs(got.F - want.F) <= 2 * STIFF_SPREAD["F"] * abs(want.F)
    assert np.abs(np.array(got.history) - np.array(want.history)).max() \
        <= 2 * STIFF_SPREAD["history"]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_projected_gradient_on_its_own_draw_keeps_the_invariants(name):
    pt = PROBLEMS[name](T)
    avail = pt.availability()
    res = T.projected_gradient(pt, steps=60, device=CPU, seed=3)
    T.validate_placement(res.x, avail)
    np.testing.assert_allclose(res.x.sum(axis=1), 1.0, atol=1e-9)
    assert (res.x[~avail] == 0).all()
    uniform = T.uniform_placement(pt.graph.n_ops, avail)
    assert res.F <= min(pt.score(uniform, dq)
                        for dq in np.linspace(0.0, 1.0, 11)) + 1e-9
    again = T.projected_gradient(pt, steps=60, device=CPU, seed=3)
    assert np.array_equal(res.x, again.x) and res.history == again.history


@pytest.mark.parametrize("temps", [(0.1,), (0.1, 0.02), (0.1, 0.02, 0.005)])
def test_projected_gradient_counts_its_steps_as_dispatches(temps):
    res = T.projected_gradient(_paper(T), steps=25, temps=temps, device=CPU)
    assert res.dispatches == 25 * len(temps) == len(res.history)
    assert res.evals > res.dispatches     # + the dq grid's exact scores


def test_projected_gradient_refuses_a_mis_shaped_start():
    with pytest.raises(ValueError, match="z0"):
        T.projected_gradient(_paper(T), steps=2, device=CPU,
                             z0=np.zeros((2, 3)))


def test_quickstart_job_through_the_port():
    """examples/quickstart.py §2: greedy and projected gradient on the
    capacity-coupled paper problem; the port's F within 1e-3 of the JAX
    result from the same start, and no worse than its greedy by more."""
    pj, pt = _paper(J), _paper(T)
    want = J.projected_gradient(pj, steps=150)
    got = T.projected_gradient(pt, steps=150, device=CPU,
                               z0=_jax_start(pj))
    assert abs(got.F - want.F) <= 1e-3
    greedy = T.greedy_transfer(pt, device=CPU)
    assert min(greedy.F, got.F) <= J.greedy_transfer(pj).F + 1e-3
    T.validate_placement(got.x, pt.availability())


def test_chip_smoke_projected_gradient_phase_rehearses_on_the_cpu(
        monkeypatch, capsys):
    """chip_smoke.py's projected_gradient phase on the CPU at 8 regions of
    2 devices (and 16 for the timed run), 10 steps a temperature: the
    card-vs-CPU checks (here CPU against CPU), F at most uniform's, the
    step count and the coupling."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(root))
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    graph = T.random_dag(cs.N_OPS, cs.EDGE_PROB,
                         np.random.default_rng(cs.SEED))
    out = cs.projected_gradient_phase(torch, np, torch.device(CPU), graph,
                                      2, 2, 10, profile=False)
    assert out["F"] <= out["uniform_F"] * (1 + 1e-5)
    assert "steps/s" in capsys.readouterr().out


def test_at_v512_neither_package_beats_the_uniform_placement():
    """The reference's temperatures (0.1, 0.02, 0.005) are absolute: on
    chip_smoke.py's search problem (12 operators, a random_fleet of 8
    regions, β 1, the phase's coupling) at 8 × 64 devices the latencies
    are ≈1e-2, and the smoothed loss is dominated by ``temp·log V``
    terms, so 100 steps a temperature end above the uniform placement's
    F in both packages (measured here: JAX 1.496×, the port from the same
    start 1.542×, the same dq); at 8 × 8 devices both beat it.  The card's
    run at V 4096 (chip_smoke.py phase 15) is held to the same
    invariants, not to F ≤ uniform."""
    from repro.core.optimizers import _dq_grid
    from repro.sim.scenarios import ScenarioConfig as JCfg
    from repro.sim.scenarios import random_fleet as j_fleet
    from repro_torch.sim.scenarios import ScenarioConfig as TCfg
    from repro_torch.sim.scenarios import random_fleet as t_fleet

    def build(mod, fleet_fn, cfg, per):
        g = mod.random_dag(12, 0.3, np.random.default_rng(0))
        fleet = fleet_fn(np.random.default_rng(9), cfg(
            n_regions=(8, 8), devices_per_region=(per, per)))
        V, u = fleet.n_devices, 12 / fleet.n_devices
        return mod.PlacementProblem(g, fleet, beta=1.0, dq=mod.DQCoupling(
            cap0=np.full(V, 4.0 * u), load=np.full(V, 2.5 * u)))

    for per, beats in ((64, False), (8, True)):
        pj = build(J, j_fleet, JCfg, per)
        pt = build(T, t_fleet, TCfg, per)
        uni = J.uniform_placement(12, pj.availability())
        uni_F = min(pj.score(uni, d) for d in _dq_grid(pj, steps=10))
        want = J.projected_gradient(pj, steps=100)
        got = T.projected_gradient(pt, steps=100, device=CPU,
                                   z0=_jax_start(pj))
        assert got.dq_fraction == want.dq_fraction
        assert (want.F < uni_F) == (got.F < uni_F) == beats, per
        T.validate_placement(got.x, pt.availability())
