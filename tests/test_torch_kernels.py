"""The plain PyTorch versions of the two edge-latency kernels against the
JAX package's Pallas kernels run in interpret mode, at the
tests/test_kernel_blocking.py shapes: V ∈ {7, 129, 300}, E ∈ {1, 33, 130, 0},
all-negative operands, shared vs per-scenario scenario batch.

Tolerance ≤1e-5 relative (max |err| / max |want|): both sides sum in
float32, in different orders.  The CUDA kernels themselves have no CPU mode;
``chip_smoke.py`` holds them against these plain versions on the card."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.edge_latency import (edge_latency_pallas,  # noqa: E402
                                        edge_latency_structured_pallas)
from repro_torch.kernels import dispatch, ref  # noqa: E402

REL = 1e-5


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _dense(rng, B, E, V, shared, negative=False):
    if negative:     # every product negative: an unmasked 0 would win
        xi = -rng.uniform(0.5, 1.0, (B, E, V))
        xj = rng.uniform(0.5, 1.0, (B, E, V))
        com = rng.uniform(0.5, 1.0, (1 if shared else B, V, V))
    else:
        xi = rng.standard_normal((B, E, V))
        xj = rng.standard_normal((B, E, V))
        com = rng.standard_normal((1 if shared else B, V, V))
    return [a.astype(np.float32) for a in (xi, xj, com)]


def _structured(rng, B, E, V, R, shared, negative=False):
    bc = 1 if shared else B
    if negative:
        xi = -rng.uniform(0.5, 1.0, (B, E, V))
        rest = [rng.uniform(0.5, 1.0, s) for s in
                ((B, E, V), (B, E, R), (bc, R, V), (bc, 1, V))]
    else:
        xi = rng.standard_normal((B, E, V))
        rest = [rng.standard_normal(s) for s in
                ((B, E, V), (B, E, R), (bc, R, V), (bc, 1, V))]
    return [a.astype(np.float32) for a in (xi, *rest)]


def _pallas_dense(args):
    return np.asarray(edge_latency_pallas(*map(jnp.asarray, args),
                                          interpret=True))


def _pallas_structured(args):
    return np.asarray(edge_latency_structured_pallas(
        *map(jnp.asarray, args), interpret=True))


def _torch(fn, args):
    return fn(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("V", [7, 129, 300])
@pytest.mark.parametrize("shared", [True, False])
def test_dense_plain_matches_pallas_odd_V(V, shared):
    args = _dense(np.random.default_rng(V), B=2, E=5, V=V, shared=shared)
    got = _torch(ref.edge_latency_dense_plain, args)
    assert got.shape == (2, 5)
    assert _rel_err(got, _pallas_dense(args)) <= REL


@pytest.mark.parametrize("E", [1, 33, 130, 0])
def test_dense_plain_matches_pallas_odd_E(E):
    args = _dense(np.random.default_rng(E + 7), B=2, E=E, V=129, shared=True)
    got = _torch(ref.edge_latency_dense_plain, args)
    assert got.shape == (2, E)
    assert _rel_err(got, _pallas_dense(args)) <= REL


def test_dense_plain_negative_operands():
    args = _dense(np.random.default_rng(11), B=2, E=4, V=130, shared=True,
                  negative=True)
    got = _torch(ref.edge_latency_dense_plain, args)
    assert got.max() < 0
    assert _rel_err(got, _pallas_dense(args)) <= REL


@pytest.mark.parametrize("V,R,shared", [(7, 1, True), (300, 1, False),
                                        (300, 8, True), (129, 8, False)])
def test_structured_plain_matches_pallas(V, R, shared):
    args = _structured(np.random.default_rng(V + R), B=2, E=5, V=V, R=R,
                       shared=shared)
    got = _torch(ref.edge_latency_structured_plain, args)
    assert got.shape == (2, 5)
    assert _rel_err(got, _pallas_structured(args)) <= REL


@pytest.mark.parametrize("E", [1, 33, 130, 0])
def test_structured_plain_matches_pallas_odd_E(E):
    args = _structured(np.random.default_rng(E + 100), B=2, E=E, V=129,
                       R=8, shared=True)
    got = _torch(ref.edge_latency_structured_plain, args)
    assert got.shape == (2, E)
    assert _rel_err(got, _pallas_structured(args)) <= REL


def test_structured_plain_negative_operands():
    args = _structured(np.random.default_rng(12), B=2, E=4, V=130, R=8,
                       shared=False, negative=True)
    got = _torch(ref.edge_latency_structured_plain, args)
    assert got.max() < 0
    assert _rel_err(got, _pallas_structured(args)) <= REL


@pytest.mark.parametrize("shared", [True, False])
def test_dispatch_cpu_route_is_the_plain_version(shared):
    """The device policy sends CPU tensors to the plain versions, bitwise."""
    rng = np.random.default_rng(5)
    d = [torch.from_numpy(a) for a in _dense(rng, 3, 4, 17, shared)]
    s = [torch.from_numpy(a) for a in _structured(rng, 3, 4, 17, 3, shared)]
    assert torch.equal(dispatch.edge_latency(*d),
                       ref.edge_latency_dense_plain(*d))
    assert torch.equal(dispatch.edge_latency_structured(*s),
                       ref.edge_latency_structured_plain(*s))


def test_plain_versions_compute_in_the_given_dtype():
    """chip_smoke holds the kernels against the plain versions in float64."""
    rng = np.random.default_rng(6)
    d = [torch.from_numpy(a).double() for a in _dense(rng, 2, 3, 9, True)]
    s = [torch.from_numpy(a).double()
         for a in _structured(rng, 2, 3, 9, 2, True)]
    assert ref.edge_latency_dense_plain(*d).dtype == torch.float64
    assert ref.edge_latency_structured_plain(*s).dtype == torch.float64
