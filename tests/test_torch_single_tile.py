"""The port's single-tile routes (K4a, K4b) on the CPU: their plain
versions against the JAX package's whole-V Pallas kernels in interpret
mode (``edge_latency_pallas_single_tile``,
``edge_latency_structured_pallas_single_tile``) and against the float64
plain version, at tests/test_kernel_blocking.py's inputs (B 2, E 5, V 64,
R 4, shared and per-scenario) and at E ∈ {1, 33}, V ∈ {1, 37, 128}; the
wrappers' refusals (CPU tensors, V over the shared-memory limit); the
routes' plans; the roofline terms; and chip_smoke.py's single_tile phase
rehearsed with the kernels swapped for counted plain versions.

Tolerance ≤1e-5 relative (max |err| / max |want|): both sides sum in
float32, in different orders.  The CUDA kernels have no CPU mode;
``chip_smoke.py`` holds them bitwise against K1/K2 on the card."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.edge_latency import (  # noqa: E402
    edge_latency_pallas_single_tile,
    edge_latency_structured_pallas_single_tile)
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import edge_latency as kernels  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402

REL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _dense(rng, B, E, V, shared):
    """tests/test_kernel_blocking.py's ``_dense_inputs``."""
    bc = 1 if shared else B
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, E, V), (B, E, V), (bc, V, V))]


def _structured(rng, B, E, V, R, shared):
    """tests/test_kernel_blocking.py's ``_structured_inputs``."""
    bc = 1 if shared else B
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, E, V), (B, E, V), (B, E, R), (bc, R, V),
                      (bc, 1, V))]


def _torch(fn, args):
    return fn(*(torch.from_numpy(a) for a in args)).numpy()


CASES = [(5, 64), (1, 64), (33, 64), (5, 1), (5, 37), (5, 128)]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("E,V", CASES)
def test_dense_route_matches_pallas_single_tile(E, V, shared):
    args = _dense(np.random.default_rng(E * 1000 + V), 2, E, V, shared)
    got = _torch(dispatch.edge_latency_single_tile, args)
    assert got.shape == (2, E)
    want = np.asarray(edge_latency_pallas_single_tile(
        *map(jnp.asarray, args), interpret=True))
    assert _rel(got, want) <= REL
    oracle = _torch(ref.edge_latency_dense_single_tile_plain,
                    [a.astype(np.float64) for a in args])
    assert _rel(got, oracle) <= REL


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("E,V", CASES)
def test_structured_route_matches_pallas_single_tile(E, V, shared):
    args = _structured(np.random.default_rng(E * 1000 + V + 1), 2, E, V, 4,
                       shared)
    got = _torch(dispatch.edge_latency_structured_single_tile, args)
    assert got.shape == (2, E)
    want = np.asarray(edge_latency_structured_pallas_single_tile(
        *map(jnp.asarray, args), interpret=True))
    assert _rel(got, want) <= REL
    oracle = _torch(ref.edge_latency_structured_single_tile_plain,
                    [a.astype(np.float64) for a in args])
    assert _rel(got, oracle) <= REL


def test_routes_plan_their_own_kind_and_are_the_blocked_function():
    """The CPU route is the plain version, which is the blocked kernels'
    plain version (the two kernels compute one function), and each route
    counts its plan under its own kind; nothing launches."""
    rng = np.random.default_rng(3)
    d = [torch.from_numpy(a) for a in _dense(rng, 2, 5, 64, True)]
    s = [torch.from_numpy(a) for a in _structured(rng, 2, 5, 64, 4, False)]
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    try:
        before = {k: reg.value("kernels.dispatch.plans", kind=k,
                               impl="plain")
                  for k in ("dense_single_tile", "structured_single_tile")}
        assert torch.equal(dispatch.edge_latency_single_tile(*d),
                           dispatch.edge_latency(*d))
        assert torch.equal(dispatch.edge_latency_structured_single_tile(*s),
                           dispatch.edge_latency_structured(*s))
        for k in before:
            assert reg.value("kernels.dispatch.plans", kind=k,
                             impl="plain") == before[k] + 1
    finally:
        reg.enabled = was
    assert kernels.launches["edge_latency_dense_single_tile"] == 0
    assert kernels.launches["edge_latency_structured_single_tile"] == 0


def test_wrappers_refuse_cpu_tensors_and_oversized_tiles():
    rng = np.random.default_rng(4)
    d = [torch.from_numpy(a) for a in _dense(rng, 2, 3, 16, True)]
    s = [torch.from_numpy(a) for a in _structured(rng, 2, 3, 16, 4, True)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_latency_dense_single_tile(*d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_latency_structured_single_tile(*s)
    # the size refusal comes first, before any device check or launch
    vmax = kernels.single_tile_max_v()
    assert vmax == 237
    assert kernels.single_tile_smem_bytes(vmax) <= kernels.SMEM_LIMIT \
        < kernels.single_tile_smem_bytes(vmax + 1)
    big = [torch.from_numpy(a) for a in _dense(rng, 1, 1, vmax + 1, True)]
    with pytest.raises(ValueError, match="largest V accepted is 237"):
        kernels.edge_latency_dense_single_tile(*big)
    vmax8 = kernels.single_tile_max_v(8)
    assert vmax8 == 6449
    with pytest.raises(ValueError, match="shared memory"):
        kernels.check_single_tile(vmax8 + 1, 8)
    kernels.check_single_tile(vmax8, 8)
    assert kernels.launches["edge_latency_dense_single_tile"] == 0


def test_single_tile_roofline_terms():
    t = roofline.edge_latency_single_tile_terms(4, 256, 237, 1)
    assert t.flops == 2.0 * 4 * 256 * 237 ** 2
    assert t.bytes == 4.0 * (2 * 4 * 256 * 237 + 237 ** 2 + 4 * 256)
    assert t.bound_by == "operations"
    t = roofline.edge_latency_structured_single_tile_terms(4, 256, 6449, 8,
                                                           1)
    assert t.flops == 2.0 * 4 * 256 * 8 * 6449
    assert t.bytes == 4.0 * (2 * 4 * 256 * 6449 + 4 * 256 * 8 + 9 * 6449
                             + 4 * 256)
    assert t.bound_by == "bytes"


def test_chip_smoke_single_tile_phase_rehearses_on_the_cpu(monkeypatch,
                                                           capsys):
    """chip_smoke.py's single_tile phase on the CPU with K1, K2, K4a and
    K4b swapped for counted plain versions (K4's keep the wrapper's size
    refusal) and the routes planned "cuda": the launch counts, the bitwise
    and float64 checks, the refusal and the timing report (K4b also
    per-batch and at R 8) all run."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))

    def counted(name, fn, R_of=None):
        def run(*args):
            if R_of is not None:
                kernels.check_single_tile(args[0].shape[-1], R_of(args))
            kernels.launches[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    for name, fn, R_of in (
            ("edge_latency_dense", ref.edge_latency_dense_plain, None),
            ("edge_latency_structured", ref.edge_latency_structured_plain,
             None),
            ("edge_latency_dense_single_tile",
             ref.edge_latency_dense_single_tile_plain, lambda a: None),
            ("edge_latency_structured_single_tile",
             ref.edge_latency_structured_single_tile_plain,
             lambda a: a[2].shape[-1])):
        monkeypatch.setattr(kernels, name, counted(name, fn, R_of))
        monkeypatch.setitem(kernels.launches, name, 0)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: 1.0)
    monkeypatch.setattr(chip_smoke, "kernel_device_ms",
                        lambda torch, fn, reps, key: 1.0)
    monkeypatch.setattr(chip_smoke, "TILE_TIMED", (2, 8))
    out = chip_smoke.single_tile_phase(torch, torch.device("cpu"))
    n = 2 * (1 + len(chip_smoke.TILE_ES) + len(chip_smoke.TILE_VS) + 1)
    assert out["launches"] == {"edge_latency_dense_single_tile": n,
                               "edge_latency_structured_single_tile": n}
    for name in out["launches"]:
        r = out["report"][name]
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["rel_err"] <= chip_smoke.REL
    printed = capsys.readouterr().out
    assert "K4a == K1 and K4b == K2 bitwise" in printed
    assert "largest V accepted: K4a 237, K4b 11616" in printed
    # the timed cases, each held bitwise against the blocked kernel
    for shape in ("V=11616 R=4 shared", "V=11616 R=4 per-batch",
                  "V=6449 R=8 shared"):
        assert (f"edge_latency_structured_single_tile [B=2 E=8 {shape}]"
                in printed)
    assert printed.count("(bitwise equal)") == 6
