"""Tests that need a CUDA card: the port's kernels (K4a/K4b against
K1/K2, K5, K6, K7 against their plain versions) on the card, the
five-objective score grid on the card against the CPU, and the smoke
models' launches.  They skip without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX (the card's machine has none), and the
card is looked for inside a fixture, never at import."""

import sys
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
try:
    import chip_smoke  # noqa: E402
finally:
    sys.path.pop(0)

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
# slow decay: 8 chunks at the model's P, N, chunk, a ragged L, and one
# lm_score shard of Mamba2-1.3B (b 11, L 2048, H 64)
SSD_SLOW_CASES = [(1, 2048, 4, 64, 128, 256), (2, 1900, 3, 64, 128, 256),
                  (11, 2048, 64, 64, 128, 256)]


def _ssd_operands(card, rng, b, L, H, P, N, dtype, slow=False):
    """tests/test_kernels.py's distributions; ``slow``: dt = softplus(z −
    6), A = −0.05·(1 + 0.1u), where states older than one chunk still
    carry a large share of y."""
    t = getattr(torch, dtype)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(card)

    x, B, C = arr(b, L, H, P).to(t), arr(b, L, N, scale=0.5).to(t), \
        arr(b, L, N, scale=0.5).to(t)
    if slow:
        dt = torch.nn.functional.softplus(arr(b, L, H) - 6.0)
        A = -0.05 * (1.0 + 0.1 * torch.from_numpy(
            rng.random(H).astype(np.float32)).to(card))
    else:
        dt = torch.nn.functional.softplus(arr(b, L, H)) * 0.5
        A = -torch.exp(arr(H) * 0.3)
    return x, B, C, dt, A, arr(H)


def _hold_ssd(args, chunk, dtype):
    """K6 against its plain version (float32: the float64 plain version at
    ≤1e-5; bfloat16: the plain version in float32 math at ≤1e-2), bitwise
    on a repeat, through the dtype's route: bfloat16 on the tensor cores
    in three passes, float32 on the CUDA cores."""
    before = dict(sk.route_launches)
    got = sk.ssd_scan(*args, chunk=chunk)
    if dtype == "float32":
        want = ref.ssd_scan_plain(*(a.double() for a in args), chunk=chunk)
        bar = 1e-5
    else:
        want = ref.ssd_scan_plain(*args, chunk=chunk)
        bar = 1e-2
    err = (got.double() - want.double()).abs().max()
    assert float(err / want.double().abs().max()) <= bar
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, sk.ssd_scan(*args, chunk=chunk))
    way = sk.route(getattr(torch, dtype))
    assert way == ("tensor_cores" if dtype == "bfloat16" else
                   "cuda_cores_f32")
    assert sk.route_launches[way] - before[way] == 2
    if way == "tensor_cores":
        assert sk.route_launches["output"] - before["output"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_the_card(card, dtype):
    """K6 against its plain version: float32 inputs against the float64
    plain version at ≤1e-5 relative, bfloat16 inputs against the plain
    version in float32 math at ≤1e-2; bitwise on a repeat."""
    rng = np.random.default_rng(21)
    for b, L, H, P, N, Q in SSD_CASES:
        _hold_ssd(_ssd_operands(card, rng, b, L, H, P, N, dtype), Q, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_carries_old_states_on_the_card(card, dtype):
    """K6 on slow-decay inputs, where the states older than one chunk
    carry more than 5 % of y (so a kernel that lost the carry across
    chunks would fail), with the bars of the test above."""
    rng = np.random.default_rng(25)
    for b, L, H, P, N, Q in SSD_SLOW_CASES:
        args = _ssd_operands(card, rng, b, L, H, P, N, dtype, slow=True)
        assert chip_smoke.older_state_share(torch, ref.ssd_scan_plain,
                                              (*args, Q)) > 0.05
        _hold_ssd(args, Q, dtype)


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
    rows and at the widths of other Mamba2 sizes (1536 to 8192, the rows
    kernel at 6 to 32 vectors per lane), with the bars of the other
    kernels; bitwise on a repeat."""
    rng = np.random.default_rng(23)
    t = getattr(torch, dtype)
    for rows, D, offset in ((1, 64, 0), (7, 2048, 0), (33, 4096, 0),
                            (9, 37, 0), (4, 256, 1), (6, 1536, 0),
                            (5, 2560, 0), (9001, 3072, 0), (3, 5120, 0),
                            (2, 8192, 0)):
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [2048, 4096])
def test_rmsnorm_kernel_at_serving_shapes_on_the_card(card, dtype, D):
    """K7 at one lm_score shard's rows (22 528) and the block / gate norm
    widths, where the row stays in registers: the bars of the other
    kernels, bitwise on a repeat."""
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((22528, D)).astype(np.float32)
                         ).to(card).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(card)
    got = rk.rmsnorm(x, w)
    if dtype == "float32":
        want, bar = ref.rmsnorm_plain(x.double(), w.double()), 1e-5
    else:
        want, bar = ref.rmsnorm_plain(x, w), 1e-2
    err = (got.double() - want.double()).abs().max()
    assert float(err / want.double().abs().max()) <= bar
    assert torch.equal(got, rk.rmsnorm(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows, D", [
    (262144, 128), (32768, 128), (512, 128), (64, 128),   # qwen3 qk-norms
    (4096, 5120), (8, 5120),                    # qwen3 block / final norms
    (4096, 4096), (8, 4096),            # granite; Mamba2-1.3B's gate norm
    (4096, 2048), (8, 2048)])                     # Mamba2-1.3B's norms
def test_rmsnorm_kernel_at_lm_serve_shapes_on_the_card(card, dtype, rows, D):
    """K7 at the rows the LM token server hands it (8 prompts of 512 in
    prefill, 8 rows a decode step; qwen3's q/k-norms over 64 / 8 heads of
    128, where every warp of the rows kernel walks many rows), with the
    bars of the other kernels; bitwise on a repeat."""
    rng = np.random.default_rng(rows + D)
    x = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)
                         ).to(card).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32)).to(card)
    got = rk.rmsnorm(x, w)
    if dtype == "float32":
        want, bar = ref.rmsnorm_plain(x.double(), w.double()), 1e-5
    else:
        want, bar = ref.rmsnorm_plain(x, w), 1e-2
    err = (got.double() - want.double()).abs().max()
    assert float(err / want.double().abs().max()) <= bar
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


def _structured_operands(card, seed, B, E, V, R, shared, offset=0):
    """x_i (at ``offset`` elements into its buffer: not 16-byte aligned
    for offset 1), x_j, mass, a, corr, seeded with numpy."""
    rng = np.random.default_rng(seed)
    bc = 1 if shared else B

    def arr(*shape, pad=0):
        n = int(np.prod(shape))
        flat = torch.from_numpy(rng.standard_normal(n + pad)
                                .astype(np.float32)).to(card)
        return flat[pad:].view(shape)

    return (arr(B, E, V, pad=offset), arr(B, E, V), arr(B, E, R),
            arr(bc, R, V), arr(bc, 1, V))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_k4b_equals_k2_at_the_timed_shape_on_the_card(card, shared):
    """K4b == K2 bitwise at B 4, E 1024, V 11 616 (the largest V at R 4),
    R 4, with a shared and a per-batch scenario; within 1e-5 of float64;
    bitwise on a repeat."""
    V = ek.single_tile_max_v(4)
    assert V == 11616
    st = _structured_operands(card, 41, 4, 1024, V, 4, shared)
    got = ek.edge_latency_structured_single_tile(*st)
    assert torch.equal(got, ek.edge_latency_structured(*st))
    assert torch.equal(got, ek.edge_latency_structured_single_tile(*st))
    want = ref.edge_latency_structured_plain(*(t.double() for t in st))
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("V,R,offset", [(1237, 4, 0), (6449, 8, 0),
                                        (1024, 4, 1)])
def test_k4b_scalar_path_equals_k2_on_the_card(card, V, R, offset, shared):
    """K4b's 4-byte path: V % 4 != 0 (1237; 6449, the largest V at R 8) and
    an x_i one element into its buffer (not 16-byte aligned) — bitwise
    equal to K2, within 1e-5 of float64."""
    st = _structured_operands(card, V + offset, 3, 70, V, R, shared, offset)
    got = ek.edge_latency_structured_single_tile(*st)
    assert torch.equal(got, ek.edge_latency_structured(*st))
    want = ref.edge_latency_structured_plain(*(t.double() for t in st))
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 1e-5


def _every_config(kind):
    from repro_torch.kernels.autotune import KernelConfig
    fields = ("stages", "group") if kind == "dense" else ("rows", "unroll")
    pairs = ek.DENSE_CONFIGS if kind == "dense" else ek.STRUCTURED_CONFIGS
    return [KernelConfig(**dict(zip(fields, p))) for p in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("V,E", [(64, 5), (7, 33), (237, 130), (129, 1)])
def test_every_k1_config_equals_the_default_and_k4a_on_the_card(card, V, E,
                                                                shared):
    """Every instantiation of K1 (ring depth, raster group) is bitwise the
    default config's launch and K4a's, and its launcher's tiles are
    ``block_geometry``'s (the single-tile shapes: V up to 237)."""
    rng = np.random.default_rng(V + E)
    B, bc = 3, 1 if shared else 3

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(card)

    d = (arr(B, E, V), arr(B, E, V), arr(bc, V, V))
    want = ek.edge_latency_dense(*d)
    assert torch.equal(want, ek.edge_latency_dense_single_tile(*d))
    for cfg in _every_config("dense"):
        assert torch.equal(ek.edge_latency_dense(*d, config=cfg), want), cfg
        g = ek.block_geometry("dense", E, V, None, cfg, B=B, com_batch=bc)
        assert ek.last_launch["edge_latency_dense"]["tiles"] == g.tiles


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("V,E,R", [(64, 5, 4), (1237, 70, 8), (6449, 3, 8),
                                   (300, 130, 1)])
def test_every_k2_config_equals_the_default_and_k4b_on_the_card(card, V, E,
                                                                R, shared):
    """Every instantiation of K2 (rows a CTA, unroll) is bitwise the
    default config's launch and K4b's, with its launcher's tiles
    ``block_geometry``'s; a config with no instantiation raises before a
    launch."""
    from repro_torch.kernels.autotune import KernelConfig
    st = _structured_operands(card, V + E + R, 3, E, V, R, shared)
    want = ek.edge_latency_structured(*st)
    assert torch.equal(want, ek.edge_latency_structured_single_tile(*st))
    for cfg in _every_config("structured"):
        got = ek.edge_latency_structured(*st, config=cfg)
        assert torch.equal(got, want), cfg
        g = ek.block_geometry("structured", E, V, R, cfg, B=3,
                              com_batch=st[3].shape[0])
        assert ek.last_launch["edge_latency_structured"]["tiles"] == g.tiles
    before = ek.launches["edge_latency_structured"]
    with pytest.raises(ValueError, match="no instantiation"):
        ek.edge_latency_structured(*st, config=KernelConfig(rows=32))
    assert ek.launches["edge_latency_structured"] == before


@pytest.mark.cuda
def test_occupancy_comes_from_the_card(card):
    """The block policy reads each instantiation's CTAs per SM from the
    card: at least the kernels' launch bounds (K1 1, K2 2)."""
    for cfg in _every_config("dense"):
        assert ek.ctas_per_sm("dense", cfg) >= 1
    for cfg in _every_config("structured"):
        assert ek.ctas_per_sm("structured", cfg, 8) >= 2


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_attention_routes_at_every_head_dim_on_the_card(card, dtype, D):
    """K5's route for the dtype (bf16: tensor cores; float32: CUDA cores)
    at every head dim it builds, at ragged S (one partial key tile, and a
    partial q tile under several key tiles), on strided views of one
    (B, S, 3H, D) tensor, causal and full: within the bar of its plain
    version, equal to its contiguous copies and bitwise on a repeat."""
    rng = np.random.default_rng(40 + D)
    dt = getattr(torch, dtype)
    for S in (37, 300):
        big = torch.from_numpy(rng.standard_normal((2, S, 6, D))
                               .astype(np.float32)).to(card).to(dt)
        q, k, v = big[:, :, 0:2], big[:, :, 2:4], big[:, :, 4:6]
        for causal in (True, False):
            got = fa.flash_attention(q, k, v, causal=causal)
            if dtype == "float32":
                want = ref.flash_attention_plain(q.double(), k.double(),
                                                 v.double(), causal=causal)
                bar = 1e-5
            else:
                want = ref.flash_attention_plain(q, k, v, causal=causal)
                bar = 1e-2
            err = (got.double() - want.double()).abs().max()
            assert float(err / want.double().abs().max()) <= bar, (S, causal)
            assert torch.equal(got, fa.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal))
            assert torch.equal(got, fa.flash_attention(q, k, v,
                                                       causal=causal))


@pytest.mark.cuda
def test_dense_kernel_at_serving_v_on_the_card(card):
    """K1 (split TF32, 32-deep stage sums) at V 4096 on 64 rows of
    placements and a region-cost com, shared and per-scenario: within 1e-5
    of float64 and bitwise on a repeat."""
    rng = np.random.default_rng(41)
    V, E = 4096, 16

    def place(B):
        w = rng.exponential(1.0, (B, E, V)) * (rng.random((B, E, V)) < 0.05)
        w[..., 0] += 1e-3
        return torch.from_numpy((w / w.sum(-1, keepdims=True))
                                .astype(np.float32)).to(card)

    region = rng.integers(0, 8, V)
    base = rng.uniform(0.5, 4.0, (8, 8))
    com = torch.from_numpy((base[region][:, region]
                            * rng.lognormal(0.0, 0.25, (V, V)))
                           .astype(np.float32)).to(card)
    for B, c in ((4, com[None]), (2, torch.stack([com, com.flip(0)]))):
        x_i, x_j = place(B) * 0.7, place(B)
        got = ek.edge_latency_dense(x_i, x_j, c)
        want = ref.edge_latency_dense_plain(x_i.double(), x_j.double(),
                                            c.double())
        assert float((got.double() - want).abs().max()
                     / want.abs().max()) <= 1e-5
        assert torch.equal(got, ek.edge_latency_dense(x_i, x_j, c))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_single_tile_dense_equals_k1_across_single_tile_shapes(card, shared):
    """K4a == K1 bitwise at every V class of a single tile (below one n8
    tile, ragged stages, one full stage, the largest V K4a accepts) and at
    E that leaves a partial CTA of rows."""
    rng = np.random.default_rng(42)
    bc = 1 if shared else 3
    for V in (1, 7, 31, 32, 33, 100, 129, ek.single_tile_max_v()):
        for E in (1, 9):
            d = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(card) for s in ((3, E, V), (3, E, V), (bc, V, V))]
            got = ek.edge_latency_dense_single_tile(*d)
            assert torch.equal(got, ek.edge_latency_dense(*d)), (V, E)


@pytest.mark.cuda
def test_tf32_switches_cannot_change_structured_or_scalarized_grids(card):
    """With TF32 matmuls switched on (either switch), a structured
    score_grid and a multi-objective scalarization raise instead of
    running their cuBLAS products in TF32; with both off they run; the
    switches are restored afterwards."""
    rng = np.random.default_rng(43)
    g = random_dag(5, 0.5, rng)
    region = rng.integers(0, 3, 30)
    fleets = [RegionFleet(region=region, inter=np.full((3, 3), 0.5),
                          degrade=rng.uniform(1.0, 2.0, 30))
              for _ in range(2)]
    xs = np.stack([random_placement(5, np.ones((5, 30), bool), rng, 0.5)
                   for _ in range(4)]).astype(np.float32)
    ev = BatchedEvaluator(g, device=card)
    pack = pack_region_fleets(fleets)
    obj = ObjectiveSet.of("latency_f", "occupancy_max")
    was_tf32 = torch.backends.cuda.matmul.allow_tf32
    was_prec = torch.get_float32_matmul_precision()
    try:
        for switch in ("allow_tf32", "precision"):
            # "highest" also clears allow_tf32, so it is set first
            torch.set_float32_matmul_precision(
                "high" if switch == "precision" else "highest")
            if switch == "allow_tf32":
                torch.backends.cuda.matmul.allow_tf32 = True
            with pytest.raises(RuntimeError, match="region masses"):
                ev.score_grid(xs, pack)
            # latency_f and an occupancy need no guarded product of their
            # own, so the scalarization is the one that refuses
            with pytest.raises(RuntimeError, match="scalarization"):
                ev.score_grid(xs, pack_fleets(fleets), objectives=obj)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        assert np.isfinite(ev.score_grid(xs, pack).cpu().numpy()).all()
        assert np.isfinite(ev.score_grid(xs, pack_fleets(fleets),
                                         objectives=obj).to_host()
                           .scalarized).all()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was_tf32
        torch.set_float32_matmul_precision(was_prec)
    assert torch.backends.cuda.matmul.allow_tf32 == was_tf32
    assert torch.get_float32_matmul_precision() == was_prec


@pytest.mark.cuda
@pytest.mark.parametrize("fleet_kind", ["dense", "structured"])
@pytest.mark.parametrize("V,rows", [(64, 4096), (4096, 1024)])
def test_batched_problem_on_the_card_matches_its_cpu_route(card, fleet_kind,
                                                           V, rows):
    """BatchedProblem on the card against the same problem on the CPU
    route (the kernels' plain versions), one chunk: the (P, D) scores
    within 1e-5 relative, the +inf masks equal, and one K1 (dense
    random_fleet) or K2 (region fleet) launch for the chunk."""
    from repro_torch.core.optimizers import DQCoupling, PlacementProblem
    from repro_torch.search import BatchedProblem, random_placements
    from repro_torch.sim.scenarios import ScenarioConfig, random_fleet

    rng = np.random.default_rng(47)
    graph = random_dag(12, 0.3, np.random.default_rng(0))
    fleet = random_fleet(rng, ScenarioConfig(
        n_regions=(8, 8), devices_per_region=(V // 8, V // 8),
        explicit_fleet=fleet_kind == "dense"))
    u = graph.n_ops / V
    prob = PlacementProblem(graph, fleet, beta=1.0, dq=DQCoupling(
        cap0=np.full(V, 4.0 * u), load=np.full(V, 2.5 * u)))
    xs = random_placements(prob.availability(), rng, rows, 0.5)
    dqs = np.linspace(0.0, 1.0, 6)
    kernel = "edge_latency_dense" if fleet_kind == "dense" \
        else "edge_latency_structured"
    eng = BatchedProblem(prob, device=card)
    ek.reset_launches()
    got = eng.score_batch(xs, dqs)
    torch.cuda.synchronize()
    assert ek.launches[kernel] == 1 and eng.dispatches == 1
    want = BatchedProblem(prob, device="cpu").score_batch(xs, dqs)
    assert got.shape == want.shape == (rows, 6)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any() and (~fin).any()
    assert np.abs(got[fin] - want[fin]).max() / np.abs(want[fin]).max() \
        <= 1e-5


def _adaptive_world(per_region: int, ticks: int, seed: int):
    """chip_smoke.py's drifting world (bench_adaptive.py's) at a small V."""
    return chip_smoke.adaptive_world(np, per_region, ticks, seed)


@pytest.mark.cuda
def test_controller_on_the_card_makes_its_cpu_routes_decisions(card):
    """The closed loop at 8 regions × 8 devices (V 64): the card's K1 grids
    give the CPU route's decisions — reconfigurations, refits, dispatches
    and the final placement — and 4 K1 launches per dispatch."""
    from repro_torch.adapt import AdaptiveConfig, run_adaptive

    cfg = AdaptiveConfig(**chip_smoke.CONTROLLER)
    reps, xs = {}, {}
    for where in (card, torch.device("cpu")):
        eng, trace = _adaptive_world(8, 24, 3)
        ek.reset_launches()
        reps[where.type] = run_adaptive(eng, trace, np.random.default_rng(4),
                                        cfg, device=where)
        xs[where.type] = eng.x
        if where.type == "cuda":
            launched = ek.launches["edge_latency_dense"]
    a, b = reps["cuda"], reps["cpu"]
    assert a.controller_dispatches > 0
    assert launched == cfg.robust_scenarios * a.controller_dispatches
    assert (a.reconfig_ticks, a.refit_ticks, a.controller_dispatches) == \
        (b.reconfig_ticks, b.refit_ticks, b.controller_dispatches)
    assert np.array_equal(xs["cuda"], xs["cpu"])
    np.testing.assert_allclose(a.f_adaptive, b.f_adaptive, rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("ridge", [1e-2, 1.0])
def test_fit_prior_on_the_card_is_its_cpu_fit(card, ridge):
    """The ridge prior on the card against device="cpu" on the tuples of
    three small drifting-world fleets with the slow tier slowed 8×: the
    pairwise Gram and the elementwise elimination round alike on both, so
    the coefficients are bitwise equal (the bar is 1e-5)."""
    from repro_torch.belief import apply_degrade, fit_prior
    from repro_torch.core.calibration import ReplayWindow
    from repro_torch.sim import merge_tuples, replay_trace, training_tuples
    from repro_torch.sim.scenarios import TraceEvent
    from repro_torch.streaming.engine import StreamingEngine

    parts = []
    for seed in (10, 11, 12):
        eng, _ = _adaptive_world(16, 1, seed)
        base = eng.fleet
        d = np.ones(base.n_devices)
        d[chip_smoke.slow_tier(np, base)] = 8.0
        world = StreamingEngine(eng.graph, apply_degrade(base, d), eng.x,
                                observed="work")
        rep = replay_trace(world, [TraceEvent(t=k, kind="rate", rate=2048.0)
                                   for k in range(4)],
                           np.random.default_rng(seed))
        parts.append(training_tuples(eng.graph.meta, base,
                                     ReplayWindow.from_report(rep, world.x)))
    c = merge_tuples(parts)
    kw = dict(device_features=c.device_features,
              device_log_degrade=c.device_log_degrade,
              device_weights=c.device_weights, ridge=ridge)
    got, want = fit_prior(**kw, device=card), fit_prior(**kw, device="cpu")
    assert np.array_equal(got.w_device, want.w_device)
    assert got.device_residual_var == want.device_residual_var


# -- the tenth slice: K5's repaired limits, K6's final state, serving -------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_takes_b_times_h_past_the_old_grid_limit(card, dtype):
    """B·H = 65 536 (the grid's y dimension held B·H and refused more than
    65 535; it is now on x) with a short S, causal, against its plain
    version (float32: the float64 plain version at ≤1e-5; bf16 ≤1e-2)."""
    rng = np.random.default_rng(41)
    t = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((4096, 24, 16, 64))
                                .astype(np.float32)).to(card).to(t)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    if dtype == "float32":
        want = ref.flash_attention_plain(q.double(), k.double(), v.double())
        bar = 1e-5
    else:
        want, bar = ref.flash_attention_plain(q, k, v), 1e-2
    err = (got.double() - want.double()).abs().max()
    assert float(err / want.double().abs().max()) <= bar
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_final_state_matches_plain_on_the_card(card, dtype):
    """K6's final state (b, H, N, P) float32 against the plain version's
    (float32 inputs: the float64 plain version at ≤1e-5; bf16: the plain
    version in float32 math at ≤1e-2), one chunk, ragged and many chunks,
    slow decay included; y bitwise the y of the call without the state,
    both bitwise on a repeat and when the state is written into a given
    buffer (``state_out``, as the model's prefill writes its cache)."""
    rng = np.random.default_rng(42)
    cases = [(c, False) for c in SSD_CASES] + [(c, True) for c in
                                               SSD_SLOW_CASES[:2]]
    for (b, L, H, P, N, Q), slow in cases:
        args = _ssd_operands(card, rng, b, L, H, P, N, dtype, slow=slow)
        y, st = sk.ssd_scan(*args, chunk=Q, final_state=True)
        if dtype == "float32":
            _, want = ref.ssd_scan_plain(*(a.double() for a in args),
                                         chunk=Q, final_state=True)
            bar = 1e-5
        else:
            _, want = ref.ssd_scan_plain(*args, chunk=Q, final_state=True)
            bar = 1e-2
        assert st.shape == (b, H, N, P) and st.dtype == torch.float32
        err = (st.double() - want.double()).abs().max()
        assert float(err / want.double().abs().max()) <= bar, (b, L, H, Q)
        assert torch.equal(y, sk.ssd_scan(*args, chunk=Q))
        y2, st2 = sk.ssd_scan(*args, chunk=Q, final_state=True)
        assert torch.equal(y, y2) and torch.equal(st, st2)
        buf = torch.full((b, H, N, P), float("nan"), device=card)
        y3, st3 = sk.ssd_scan(*args, chunk=Q, state_out=buf)
        assert st3 is buf and torch.equal(st3, st) and torch.equal(y3, y)


@pytest.mark.cuda
def test_ssd_state_out_refuses_a_mismatched_buffer(card):
    """K6 writes its final state only into a contiguous float32
    (b, H, N, P) tensor on x's card."""
    rng = np.random.default_rng(44)
    args = _ssd_operands(card, rng, 2, 40, 3, 8, 16, "float32")
    good = torch.empty((2, 3, 16, 8), device=card)
    for bad in (good[..., :4], good.transpose(2, 3),
                good.double(), torch.empty((2, 3, 16, 8))):
        with pytest.raises(ValueError, match="state_out"):
            sk.ssd_scan(*args, chunk=16, state_out=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo_1b", "granite_8b",
                                  "deepseek_coder_33b", "qwen3_32b",
                                  "mamba2_1_3b", "zamba2_1_2b"])
def test_serve_wave_on_the_card_matches_the_cpu_route(card, arch):
    """The smoke models serve the same greedy tokens on the card (K6 in
    Mamba2's prefill, K7 in every RMSNorm, float32) as on the CPU route,
    with the launches the model implies."""
    from repro_torch.launch.serve import serve_wave
    cfg = get_smoke_config(arch)
    host = build_model(cfg, device="cpu")
    host.init_params(torch.Generator().manual_seed(0))
    model = build_model(cfg, device=card)
    model.load_state_dict(host.state_dict())
    prompts = np.random.default_rng(43).integers(0, cfg.vocab, (4, 20),
                                                 dtype=np.int32)
    want, _ = serve_wave(host, cfg, prompts, 6)
    before = (sk.launches["ssd_scan"], rk.launches["rmsnorm"])
    got, _ = serve_wave(model, cfg, prompts, 6)
    np.testing.assert_array_equal(got, want)
    per = chip_smoke.expected_launches(cfg)
    assert (sk.launches["ssd_scan"] - before[0],
            rk.launches["rmsnorm"] - before[1]) == \
        (per.get("ssd_scan", 0), per["rmsnorm"] * 6)


# -- the Zamba2 hybrid's shapes ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [2048, 100])
def test_attention_at_the_zamba2_shape_on_the_card(card, S):
    """K5 on bf16 operands at Zamba2-1.2B's lm_score shard (B·H 11 × 32,
    head dim 64, causal) and at a ragged S, against its plain version in
    float32 math at ≤1e-2, bitwise on a repeat."""
    gen = torch.Generator(device=card).manual_seed(51)
    q, k, v = (torch.randn((11, S, 32, 64), generator=gen, device=card)
               .bfloat16() for _ in range(3))
    fa.check_shape(11, S, 32, 64)
    got = fa.flash_attention(q, k, v, causal=True)
    again = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(rel) <= 1e-2 and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", [
    ("float32", (2, 300, 6, 64, 64, 256)), ("float32", (1, 700, 4, 64, 64,
                                                         256)),
    ("bfloat16", (2, 300, 6, 64, 64, 256)),
    ("bfloat16", (11, 2048, 64, 64, 64, 256))])
def test_ssd_kernel_at_state_64_on_the_card(card, dtype, case):
    """K6 at Zamba2's state N 64 (H 64, P 64, chunk 256; the last case is
    one lm_score shard) with the bars of the tests above."""
    b, L, H, P, N, Q = case
    rng = np.random.default_rng(52)
    _hold_ssd(_ssd_operands(card, rng, b, L, H, P, N, dtype), Q, dtype)


@pytest.mark.cuda
def test_zamba2_smoke_model_on_the_card_matches_the_cpu_route(card):
    """The Zamba2 smoke model on K5's route, float32 activations: K5 once
    per site, K6 once per layer, K7 2·layers + 2·sites + 1 times a forward,
    logits ≤1e-5 relative to the CPU route's; counted on the card, each
    kernel reports every launch."""
    from repro_torch.perf import counts
    cfg = get_smoke_config("zamba2_1_2b").replace(attention_impl="pallas")
    host = build_model(cfg, device="cpu")
    host.init_params(torch.Generator().manual_seed(0))
    model = build_model(cfg, device=card)
    model.load_state_dict(host.state_dict())
    toks = np.random.default_rng(53).integers(0, cfg.vocab, (3, 40))
    with torch.inference_mode():
        want, _ = host({"tokens": toks})
        before = chip_smoke.lm_launches()
        with counts.OpCounter() as c:
            got, _ = model({"tokens": toks})
        after = chip_smoke.lm_launches()
    per = chip_smoke.expected_launches(cfg)
    assert {k: after[k] - before[k] for k in per} == per
    assert {k: v["launches"] for k, v in c.stats().kernels.items()} == per
    rel = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(rel) <= 1e-5



# -- the twelfth slice: the MoE decoder, the VLM, Whisper --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,D", [(22528, 7168), (4096, 6144),
                                    (12000, 1280), (8, 7168), (8, 6144)])
def test_rmsnorm_kernel_at_the_new_widths_on_the_card(card, dtype, rows, D):
    """K7 at the widths this slice's models hand it: Arctic's 7168 (an
    lm_score shard's 22 528 rows, a decode step's 8), Grok's 6144 (a
    prefill's 4096 rows), Whisper's 1280 (8 × 1500 encoder frames) — the
    bars of the tests above, bitwise on a repeat."""
    gen = torch.Generator(device=card).manual_seed(D + rows)
    x = torch.randn((rows, D), generator=gen, device=card).to(
        getattr(torch, dtype))
    w = torch.randn(D, generator=gen, device=card)
    got = rk.rmsnorm(x, w)
    if dtype == "float32":
        want, bar = ref.rmsnorm_plain(x.double(), w.double()), 1e-5
    else:
        want, bar = ref.rmsnorm_plain(x, w), 1e-2
    rel = (got.double() - want.double()).abs().max() / want.abs().max()
    assert float(rel) <= bar
    assert torch.equal(got, rk.rmsnorm(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D", [(2, 2048, 56, 128), (2, 512, 48, 128),
                                     (2, 512, 32, 128), (2, 512, 20, 64)])
def test_attention_at_the_new_head_counts_on_the_card(card, B, S, H, D):
    """K5 on bf16 operands at Arctic's H 56, Grok's 48, Llama-Vision's 32
    (D 128) and Whisper's decoder H 20 (D 64), causal, against its plain
    version in float32 math at ≤1e-2, bitwise on a repeat."""
    gen = torch.Generator(device=card).manual_seed(H)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=card)
               .bfloat16() for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_plain(q, k, v, causal=True)
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(rel) <= 1e-2
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=True))


def _card_and_host(card, cfg):
    host = build_model(cfg, device="cpu")
    host.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for s, cb in enumerate(getattr(host, "cross", ())):
            cb.gate.fill_(0.5 * (-1) ** s)
    model = build_model(cfg, device=card)
    model.load_state_dict(host.state_dict())
    return host, model


def _extras(cfg, B, seed=61):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"audio_frames": rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic_480b", "grok_1_314b",
                                  "llama_3_2_vision_11b", "whisper_large_v3"])
def test_new_smoke_models_on_the_card_match_the_cpu_route(card, arch):
    """The smoke MoE, VLM and audio models on K5's route, float32
    activations: K5 and K7 launched as the model implies in a forward,
    logits ≤1e-5 relative to the CPU route's (the MoE routing on the card
    the CPU route's); ``serve_wave`` with the extras serves the same
    tokens, with K7 per prefill and decode step and no K5."""
    from repro_torch.launch.serve import serve_wave
    cfg = get_smoke_config(arch).replace(attention_impl="pallas")
    host, model = _card_and_host(card, cfg)
    toks = np.random.default_rng(62).integers(0, cfg.vocab, (3, 40))
    batch = {"tokens": toks, **_extras(cfg, 3)}
    with torch.inference_mode():
        want, want_aux = host(batch)
        before = chip_smoke.lm_launches()
        got, aux = model(batch)
        after = chip_smoke.lm_launches()
    per = chip_smoke.expected_launches(cfg)
    assert {k: after[k] - before[k] for k in per} == per
    rel = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(rel) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * max(
        1.0, abs(float(want_aux)))
    prompts = np.random.default_rng(63).integers(0, cfg.vocab, (4, 20),
                                                 dtype=np.int32)
    extras = _extras(cfg, 4)
    want_toks, _ = serve_wave(host, cfg, prompts, 6, extras)
    before = chip_smoke.lm_launches()
    got_toks, _ = serve_wave(model, cfg, prompts, 6, extras)
    after = chip_smoke.lm_launches()
    np.testing.assert_array_equal(got_toks, want_toks)
    pre, dec = (chip_smoke.expected_launches(cfg, m)
                for m in ("prefill", "decode"))
    assert after["rmsnorm"] - before["rmsnorm"] == \
        pre["rmsnorm"] + 5 * dec["rmsnorm"]
    assert after["flash_attention"] == before["flash_attention"]


# -- the thirteenth slice: K7's backward, the trainer ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,D,offset", [(8192, 64, 0), (300, 4096, 0),
                                           (9, 7168, 0), (33, 100, 0),
                                           (5, 2048, 1)])
def test_rmsnorm_backward_matches_plain_on_the_card(card, dtype, rows, D,
                                                    offset):
    """K7's backward against autograd through the plain version: float32
    dx ≤1e-5 relative to the float64 plain version; bfloat16 dx within one
    bf16 ulp of the largest (≤1e-2) of the plain version on the same
    operands; dw (float32) ≤1e-4 to the float64 plain version.  D 64 to
    7168, a D that takes single elements (100) and operands one element
    into their buffers (not 16-byte aligned)."""
    td = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(rows + D)
    x = torch.randn(rows * D + offset, generator=gen, device=card)
    g = torch.randn(rows * D + offset, generator=gen, device=card)
    x, g = (t.to(td)[offset:].view(rows, D) for t in (x, g))
    w = 1 + 0.1 * torch.randn(D, generator=gen, device=card)
    dx, dw = rk.rmsnorm_bwd(x, w, g)
    wide = ref.rmsnorm_bwd_plain(x.double(), w.double(), g.double())
    plain = ref.rmsnorm_bwd_plain(x, w, g)
    want_dx = wide[0] if dtype == "float32" else plain[0]
    bar = 1e-5 if dtype == "float32" else 1e-2
    rel = (dx.double() - want_dx.double()).abs().max() / \
        want_dx.double().abs().max()
    assert dx.dtype == td and float(rel) <= bar
    rel_dw = (dw.double() - wide[1]).abs().max() / wide[1].abs().max()
    assert dw.dtype == torch.float32 and float(rel_dw) <= 1e-4


@pytest.mark.cuda
def test_rmsnorm_backward_is_deterministic_on_the_card(card):
    """Two launches on the same operands give dx and dw bitwise equal (dw's
    partials are summed in a fixed order, no atomics), at a shape whose
    grid is capped by the partials' scratch (8192 × 4096 bf16: 512 CTAs of
    16 rows) and at a qk-norm's (65 536 rows × 128)."""
    gen = torch.Generator(device=card).manual_seed(5)
    for rows, D in ((8192, 4096), (65536, 128)):
        x = torch.randn(rows, D, generator=gen, device=card).bfloat16()
        g = torch.randn(rows, D, generator=gen, device=card).bfloat16()
        w = torch.rand(D, generator=gen, device=card) + 0.5
        first = rk.rmsnorm_bwd(x, w, g)
        for _ in range(3):
            again = rk.rmsnorm_bwd(x, w, g)
            assert torch.equal(first[0], again[0])
            assert torch.equal(first[1], again[1])


@pytest.mark.cuda
def test_routes_without_a_backward_raise_under_grad_on_the_card(card):
    """K1, K2, K4a, K4b and K5 raise under grad on the card instead of
    returning a tensor without a ``grad_fn``; K7 and K6 differentiate, each
    through one launch of its backward."""
    from repro_torch.kernels import dispatch
    x = torch.rand(2, 3, 8, device=card, requires_grad=True)
    com = torch.rand(1, 8, 8, device=card)
    mass, a, corr = (torch.rand(2, 3, 2, device=card),
                     torch.rand(1, 2, 8, device=card),
                     torch.rand(1, 1, 8, device=card))
    q = torch.rand(1, 64, 2, 64, device=card, requires_grad=True)
    B = torch.rand(1, 64, 16, device=card)
    for call in (lambda: dispatch.edge_latency(x, x, com),
                 lambda: dispatch.edge_latency_structured(x, x, mass, a,
                                                          corr),
                 lambda: dispatch.edge_latency_single_tile(x, x, com),
                 lambda: dispatch.edge_latency_structured_single_tile(
                     x, x, mass, a, corr),
                 lambda: dispatch.flash_attention(q, q, q)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    y6 = dispatch.ssd_scan(q, B, B, torch.rand(1, 64, 2, device=card),
                           -torch.rand(2, device=card),
                           torch.rand(2, device=card), 64)
    assert y6.grad_fn is not None
    before = sk.launches["ssd_scan_bwd"]
    y6.sum().backward()
    assert sk.launches["ssd_scan_bwd"] == before + 1 and q.grad is not None
    q.grad = None
    w = torch.ones(64, device=card, requires_grad=True)
    y = dispatch.rmsnorm(q, w)
    assert y.grad_fn is not None
    before = rk.launches["rmsnorm_bwd"]
    y.sum().backward()
    assert rk.launches["rmsnorm_bwd"] == before + 1
    assert q.grad is not None and w.grad is not None


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu_route(card):
    """One training step of the granite smoke model (float32 activations,
    full remat) on the card against the CPU route from the same weights and
    batch: loss and gradient norm ≤1e-5, every parameter after the step
    ≤1e-4 (Adam's first step moves a gradient at the roundoff floor by ±lr
    either way); K7 launched as ``expected_launches(mode="train")``."""
    from repro_torch.train import optim, steps
    cfg = get_smoke_config("granite_8b")
    host, model = _card_and_host(card, cfg)
    rng = np.random.default_rng(64)
    t = rng.integers(0, cfg.vocab, (4, 33), dtype=np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:],
             "loss_mask": (rng.random((4, 32)) > 0.3).astype(np.float32)}
    out = {}
    for name, m in (("cpu", host), ("card", model)):
        ocfg = optim.AdamWConfig()
        state = optim.adamw_init(dict(m.named_parameters()), ocfg)
        before = chip_smoke.lm_launches()
        _, met = steps.make_train_step(m, cfg, ocfg)(state, batch)
        after = chip_smoke.lm_launches()
        out[name] = met, {k: after[k] - before[k] for k in after}
    want = chip_smoke.expected_launches(cfg, "train")
    assert {k: out["card"][1][k] for k in want} == want
    for k in ("loss", "grad_norm"):
        assert abs(float(out["card"][0][k]) - float(out["cpu"][0][k])) <= \
            1e-5 * abs(float(out["cpu"][0][k]))
    for (n, p), q in zip(model.named_parameters(), host.parameters()):
        rel = (p.detach().cpu() - q.detach()).abs().max() / q.abs().max()
        assert float(rel) <= 1e-4, n


def _norm_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_matches_plain_on_the_card(card, dtype):
    """K6 under grad on the card: ``dispatch.ssd_scan`` returns a tensor
    with a ``grad_fn`` whose backward launches ``ssd_scan_bwd`` once; the
    gradients against ``ssd_scan_bwd_plain`` norm-wise (float32 against the
    float64 plain version ≤1e-5, bfloat16 against the plain version in
    float32 math ≤1e-2), at a ragged L over chunks of 256, at L < chunk,
    at the smoke widths and at head counts that are not multiples of a
    chunk CTA's heads (5 and 3: 2 heads a CTA on the bf16 route, 4 on the
    float32 one); the wrapper bitwise on repeat."""
    from repro_torch.kernels import dispatch
    rng = np.random.default_rng(28)
    bar = 1e-5 if dtype == "float32" else 1e-2
    for b, L, H, P, N, Q in ((2, 300, 6, 64, 128, 256),
                             (1, 100, 5, 64, 64, 256),
                             (2, 20, 4, 8, 16, 8),
                             (1, 700, 3, 64, 128, 256)):
        ops = _ssd_operands(card, rng, b, L, H, P, N, dtype)
        leaves = [t.detach().clone().requires_grad_() for t in ops]
        y = dispatch.ssd_scan(*leaves, Q)
        assert y.grad_fn is not None
        dy = torch.from_numpy(rng.standard_normal(y.shape).astype(
            np.float32)).to(card).to(y.dtype)
        before = sk.launches["ssd_scan_bwd"]
        got = torch.autograd.grad(y, leaves, dy)
        assert sk.launches["ssd_scan_bwd"] == before + 1
        if dtype == "float32":
            want = ref.ssd_scan_bwd_plain(*(t.double() for t in ops),
                                          dy.double(), Q)
        else:
            want = ref.ssd_scan_bwd_plain(*ops, dy, Q)
        for g, w, t in zip(got, want, ops):
            assert g.dtype == t.dtype and g.shape == t.shape
            assert _norm_rel(g, w) <= bar
        again = sk.ssd_scan_bwd(*ops, dy, Q)
        assert all(torch.equal(a, g) for a, g in zip(
            again, sk.ssd_scan_bwd(*ops, dy, Q)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_takes_strided_views_on_the_card(card, dtype):
    """K6's backward on x, B, C as views of one conv output (the model's
    operands) and dy as a view with a padded head stride, at H 3 (not a
    multiple of a chunk CTA's heads): bitwise the same gradients as on
    contiguous copies, and within the bar of the plain version."""
    rng = np.random.default_rng(29)
    b, L, H, P, N, Q = 2, 600, 3, 64, 128, 256
    t = getattr(torch, dtype)
    conv = torch.from_numpy(rng.standard_normal(
        (b, L, H * P + 2 * N)).astype(np.float32)).to(card).to(t)
    x = conv[..., :H * P].reshape(b, L, H, P)
    B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, L, H)).astype(np.float32)).to(card) - 2.0)
    A = -torch.linspace(1.0, 16.0, H, device=card)
    D = torch.from_numpy(rng.standard_normal(H).astype(np.float32)).to(card)
    wide = torch.from_numpy(rng.standard_normal(
        (b, L, H, P + 16)).astype(np.float32)).to(card).to(t)
    dy = wide[..., :P]
    assert not dy.is_contiguous() and not x.is_contiguous()
    got = sk.ssd_scan_bwd(x, B, C, dt, A, D, dy, Q)
    flat = sk.ssd_scan_bwd(x.contiguous(), B.contiguous(), C.contiguous(),
                           dt, A, D, dy.contiguous(), Q)
    assert all(torch.equal(g, f) for g, f in zip(got, flat))
    if dtype == "float32":
        want = ref.ssd_scan_bwd_plain(
            *(a.double() for a in (x, B, C, dt, A, D, dy)), Q)
    else:
        want = ref.ssd_scan_bwd_plain(x, B, C, dt, A, D, dy, Q)
    bar = 1e-5 if dtype == "float32" else 1e-2
    assert max(_norm_rel(g, w) for g, w in zip(got, want)) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_1_2b"])
def test_ssm_train_step_on_the_card_matches_the_cpu_route(card, arch):
    """One training step of the Mamba2 (and Zamba2 hybrid) smoke model
    (float32 activations, full remat) on the card against the CPU route
    from the same weights and batch: loss and gradient norm ≤1e-5, every
    parameter after the step ≤1e-4 (as the granite step); K6, its backward
    and K7 launched as ``expected_launches(mode="train")``."""
    from repro_torch.train import optim, steps
    cfg = get_smoke_config(arch)
    host, model = _card_and_host(card, cfg)
    rng = np.random.default_rng(65)
    t = rng.integers(0, cfg.vocab, (4, 33), dtype=np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:],
             "loss_mask": (rng.random((4, 32)) > 0.3).astype(np.float32)}
    out = {}
    for name, m in (("cpu", host), ("card", model)):
        ocfg = optim.AdamWConfig()
        state = optim.adamw_init(dict(m.named_parameters()), ocfg)
        before = chip_smoke.lm_launches()
        _, met = steps.make_train_step(m, cfg, ocfg)(state, batch)
        after = chip_smoke.lm_launches()
        out[name] = met, {k: after[k] - before[k] for k in after}
    want = chip_smoke.expected_launches(cfg, "train")
    assert want["ssd_scan_bwd"] == cfg.n_layers
    assert {k: out["card"][1][k] for k in want} == want
    for k in ("loss", "grad_norm"):
        assert abs(float(out["card"][0][k]) - float(out["cpu"][0][k])) <= \
            1e-5 * abs(float(out["cpu"][0][k]))
    for (n, p), q in zip(model.named_parameters(), host.parameters()):
        rel = (p.detach().cpu() - q.detach()).abs().max() / q.abs().max()
        assert float(rel) <= 1e-4, n
