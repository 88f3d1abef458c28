"""Tests that need a CUDA card: the port's kernels (K4a/K4b against
K1/K2, K5, K6, K7 against their plain versions) on the card, the
five-objective score grid on the card against the CPU, and the smoke
models' launches.  They skip without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX (the card's machine has none), and the
card is looked for inside a fixture, never at import."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import OBJECTIVES, ObjectiveSet, RegionFleet  # noqa: E402
from repro_torch.core.graph import random_dag  # noqa: E402
from repro_torch.core.placement import random_placement  # noqa: E402
from repro_torch.kernels import edge_latency as ek  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sim import (BatchedEvaluator, pack_fleets,  # noqa: E402
                             pack_region_fleets, pack_speeds)

# tests/test_kernels.py's shapes, a ragged S and every head dim K5 builds
SHAPES = [(1, 128, 1, 64), (2, 128, 4, 64), (1, 256, 2, 128),
          (2, 96, 3, 32), (1, 384, 2, 64), (2, 100, 2, 16),
          (1, 1000, 2, 128)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_the_card(card, dtype, causal):
    """K5 against its plain version on the same card: float32 inputs
    against the float64 plain version at ≤1e-5 relative; bfloat16 inputs
    against the plain version in float32 math, within one bfloat16 ulp
    of the largest output (≤1e-2 relative); bitwise on a repeat."""
    rng = np.random.default_rng(11)
    for B, S, H, D in SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                    .astype(np.float32)).to(card)
                   .to(getattr(torch, dtype)) for _ in range(3))
        got = fa.flash_attention(q, k, v, causal=causal)
        if dtype == "float32":
            want = ref.flash_attention_plain(q.double(), k.double(),
                                             v.double(), causal=causal)
            bar = 1e-5
        else:
            want = ref.flash_attention_plain(q, k, v, causal=causal)
            bar = 1e-2
        err = (got.double() - want.double()).abs().max()
        assert float(err / want.double().abs().max()) <= bar, (B, S, H, D)
        assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
def test_kernel_reads_strided_operands_on_the_card(card):
    """Views with non-contiguous (B, S, H) strides give the same output as
    their contiguous copies, bitwise."""
    rng = np.random.default_rng(12)
    big = torch.from_numpy(rng.standard_normal((2, 70, 6, 64))
                           .astype(np.float32)).to(card)
    q, k, v = big[:, :, 0:2], big[:, :, 2:4], big[:, :, 4:6]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_smoke_model_routes_agree_on_the_card(card):
    """The OLMo smoke model on the card: the K5 route and the chunked
    reference route give the same logits within 1e-5 relative at float32
    activations, and K5 runs once per layer."""
    cfg = get_smoke_config("olmo_1b")
    model = build_model(cfg.replace(attention_impl="pallas"), device=card)
    model.init_params(torch.Generator(device=card).manual_seed(0))
    ref_model = build_model(cfg.replace(attention_impl="reference"),
                            device=card)
    ref_model.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (3, 130))).to(card)
    before = fa.launches["flash_attention"]
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
        want, _ = ref_model({"tokens": toks})
    assert fa.launches["flash_attention"] - before == cfg.n_layers
    rel = (got - want).abs().max() / want.abs().max()
    assert float(rel) <= 1e-5


# K6 cases (b, L, H, P, N, chunk): tests/test_kernels.py's shapes, ragged L
# in one chunk and over several, and the model's P, N and chunk
SSD_CASES = [(2, 64, 8, 16, 16, 16), (1, 128, 4, 32, 8, 16),
             (2, 32, 2, 8, 4, 16), (1, 20, 5, 8, 16, 8),
             (2, 300, 6, 64, 128, 256)]


def _ssd_operands(card, rng, b, L, H, P, N, dtype):
    t = getattr(torch, dtype)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(card)

    x, B, C = arr(b, L, H, P).to(t), arr(b, L, N, scale=0.5).to(t), \
        arr(b, L, N, scale=0.5).to(t)
    dt = torch.nn.functional.softplus(arr(b, L, H)) * 0.5
    return x, B, C, dt, -torch.exp(arr(H) * 0.3), arr(H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_the_card(card, dtype):
    """K6 against its plain version: float32 inputs against the float64
    plain version at ≤1e-5 relative, bfloat16 inputs against the plain
    version in float32 math at ≤1e-2; bitwise on a repeat."""
    rng = np.random.default_rng(21)
    for b, L, H, P, N, Q in SSD_CASES:
        args = _ssd_operands(card, rng, b, L, H, P, N, dtype)
        got = sk.ssd_scan(*args, chunk=Q)
        if dtype == "float32":
            want = ref.ssd_scan_plain(*(a.double() for a in args), chunk=Q)
            bar = 1e-5
        else:
            want = ref.ssd_scan_plain(*args, chunk=Q)
            bar = 1e-2
        err = (got.double() - want.double()).abs().max()
        assert float(err / want.double().abs().max()) <= bar, (b, L, H, Q)
        assert torch.equal(got, sk.ssd_scan(*args, chunk=Q))


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_views_on_the_card(card):
    """x, B, C as views of one (b, L, H·P + 2N) tensor, as the model passes
    them, give the contiguous copies' output bitwise."""
    rng = np.random.default_rng(22)
    b, L, H, P, N = 2, 70, 4, 16, 8
    conv = torch.from_numpy(rng.standard_normal((b, L, H * P + 2 * N))
                            .astype(np.float32)).to(card).bfloat16()
    x = conv[..., :H * P].reshape(b, L, H, P)
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    _, _, _, dt, A, D = _ssd_operands(card, rng, b, L, H, P, N, "bfloat16")
    got = sk.ssd_scan(x, B, C, dt, A, D, chunk=32)
    want = sk.ssd_scan(x.contiguous(), B.contiguous(), C.contiguous(), dt,
                       A, D, chunk=32)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_the_card(card, dtype):
    """K7 against its plain version at vectorised, scalar and unaligned
    rows, with the bars of the other kernels; bitwise on a repeat."""
    rng = np.random.default_rng(23)
    t = getattr(torch, dtype)
    for rows, D, offset in ((1, 64, 0), (7, 2048, 0), (33, 4096, 0),
                            (9, 37, 0), (4, 256, 1)):
        flat = torch.from_numpy(rng.standard_normal(rows * D + offset)
                                .astype(np.float32)).to(card).to(t)
        x = flat[offset:].view(rows, D)
        w = torch.from_numpy(rng.standard_normal(D).astype(np.float32)) \
            .to(card)
        got = rk.rmsnorm(x, w)
        if dtype == "float32":
            want, bar = ref.rmsnorm_plain(x.double(), w.double()), 1e-5
        else:
            want, bar = ref.rmsnorm_plain(x, w), 1e-2
        err = (got.double() - want.double()).abs().max()
        assert float(err / want.double().abs().max()) <= bar, (rows, D)
        assert torch.equal(got, rk.rmsnorm(x, w))


@pytest.mark.cuda
def test_mamba2_smoke_model_runs_k6_and_k7_on_the_card(card):
    """The Mamba2 smoke model on the card: K6 once per layer, K7 2·layers+1
    times per forward, and logits within 1e-5 relative of the same forward
    through the plain versions (float32 activations)."""
    cfg = get_smoke_config("mamba2_1_3b")
    model = build_model(cfg, device=card)
    model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab, (3, 50))).to(card)
    before = (sk.launches["ssd_scan"], rk.launches["rmsnorm"])
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert (sk.launches["ssd_scan"] - before[0],
            rk.launches["rmsnorm"] - before[1]) == \
        (cfg.n_layers, 2 * cfg.n_layers + 1)
    saved = sk.ssd_scan, rk.rmsnorm
    sk.ssd_scan, rk.rmsnorm = ref.ssd_scan_plain, ref.rmsnorm_plain
    try:
        with torch.inference_mode():
            want, _ = model({"tokens": toks})
    finally:
        sk.ssd_scan, rk.rmsnorm = saved
    rel = (got - want).abs().max() / want.abs().max()
    assert float(rel) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_single_tile_kernels_equal_the_blocked_ones_on_the_card(card,
                                                                shared):
    """K4a == K1 and K4b == K2 bitwise at tests/test_kernel_blocking.py's
    inputs (B 2, E 5, V 64, R 4), both within 1e-5 of float64."""
    rng = np.random.default_rng(31)
    bc = 1 if shared else 2

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(card)

    d = (arr(2, 5, 64), arr(2, 5, 64), arr(bc, 64, 64))
    st = (arr(2, 5, 64), arr(2, 5, 64), arr(2, 5, 4), arr(bc, 4, 64),
          arr(bc, 1, 64))
    got = ek.edge_latency_dense_single_tile(*d)
    assert torch.equal(got, ek.edge_latency_dense(*d))
    want = ref.edge_latency_dense_plain(*(t.double() for t in d))
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-5
    got = ek.edge_latency_structured_single_tile(*st)
    assert torch.equal(got, ek.edge_latency_structured(*st))
    want = ref.edge_latency_structured_plain(*(t.double() for t in st))
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_single_tile_size_refusal_on_the_card(card):
    V = ek.single_tile_max_v() + 1
    x = torch.zeros((1, 1, V), device=card)
    before = ek.launches["edge_latency_dense_single_tile"]
    with pytest.raises(ValueError, match="shared memory"):
        ek.edge_latency_dense_single_tile(x, x, torch.zeros((1, V, V),
                                                            device=card))
    assert ek.launches["edge_latency_dense_single_tile"] == before


@pytest.mark.cuda
def test_five_objective_grid_on_the_card_matches_the_cpu(card):
    """score_grid with all five objectives on the card (K1/K2, cuBLAS
    products in full FP32) within 1e-5 relative (abs 1e-6) of the same
    call with device="cpu", on a dense pack and on a family."""
    rng = np.random.default_rng(32)
    g = random_dag(6, 0.5, rng)
    V, R = 40, 3
    region = rng.integers(0, R, V)
    fleets = []
    for k in range(3):
        inter = rng.uniform(0.1, 2.0, (R, R))
        fleets.append(RegionFleet(
            region=region, inter=(inter + inter.T) / 2,
            degrade=None if k == 0 else rng.uniform(1.0, 3.0, V),
            speed=rng.lognormal(0.0, 0.3, V)))
    xs = np.stack([random_placement(6, np.ones((6, V), bool), rng, 0.5)
                   for _ in range(16)]).astype(np.float32)
    obj = ObjectiveSet.of(*OBJECTIVES)
    dq = np.array([0.1, 0.4, 0.7])
    for pack, speed in ((pack_fleets(fleets), pack_speeds(fleets)),
                        (pack_region_fleets(fleets), None)):
        got = BatchedEvaluator(g, device=card).score_grid(
            xs, pack, dq=dq, beta=0.6, objectives=obj, speed=speed).to_host()
        want = BatchedEvaluator(g, device="cpu").score_grid(
            xs, pack, dq=dq, beta=0.6, objectives=obj, speed=speed).to_host()
        for name in obj.names:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.scalarized, want.scalarized,
                                   rtol=1e-5, atol=1e-6)
