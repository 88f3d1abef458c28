"""The numerics of the port's tensor-core kernels, pinned on the CPU.

The CUDA kernels have no CPU mode, so their two numerics decisions are
emulated here in numpy / PyTorch and held against the JAX package and the
float64 oracle:

* K1 (dense edge latency) sums ``com @ x_j`` in split TF32: each float32
  operand a = hi + lo with hi = tf32(a), lo = tf32(a − hi) (round to
  nearest, ties away, by mantissa masking), three TF32 products per k8
  step (lo·hi, hi·lo, hi·hi), each 32-deep v stage in a fresh accumulator,
  the stages added in ascending v with round-to-nearest float32 adds —
  the order ``csrc/edge_latency.cu`` runs.  The tensor cores' own
  accumulation is undocumented, so the emulation takes the pessimistic
  model: each product's exact sum is added to the accumulator and the
  result is truncated toward zero to float32.  At V 4096 on 64 rows of
  placements (non-negative, as the serving path sends) it must stay within
  the 1e-5 bar of the float64 oracle and of ``edge_latency_pallas`` in
  interpret mode.
* K5 (flash attention) on bf16 operands rounds each softmax weight p to
  bf16 once, relative to the running max of its 64-key tile, and sums the
  rounded weights into l (``csrc/flash_attention.cu``).  Its plain version
  with that rounding must stay within one bf16 ulp of the largest output
  (1e-2 relative, ``BF16_REL``) of the Pallas kernel in interpret mode and
  of ``flash_attention_plain``.

* K6 (the SSD scan) on bf16 operands runs three chunk-parallel passes
  (chunk states, state passing, output) on the tensor cores and rounds the
  three operands that are not inputs (w ⊙ x, M and S) to bf16 once each
  (``csrc/ssd_scan.cu``).  ``chip_smoke.ssd_three_pass`` emulates that
  design in torch: in float64 with no rounding it must equal
  ``ssd_scan_plain`` within 1e-12 (fast and slow decay, ragged L), and
  with the kernel's rounding it must stay within 1e-2 of the plain version
  and of the Pallas kernel in interpret mode.  The three candidates (bf16
  once, bf16 hi + lo, TF32) are reported at a serving-like shape.

* K6's backward on bf16 operands (``csrc/ssd_scan_bwd.cu``, namespace tc)
  runs its products on the tensor cores and rounds the six operands that
  are not inputs (w ⊙ x, e ⊙ dy, M, dG summed over a CTA's heads, S_c,
  dS_{c+1}) to bf16 once each.  ``chip_smoke.ssd_bwd_passes`` emulates its
  passes: in float64 with nothing rounded it must equal
  ``ssd_scan_bwd_plain`` within 1e-12 (ragged L, one chunk, H not a
  multiple of a CTA's heads); with the kernel's rounding at a
  training-like shape each gradient must stay within 5e-3 norm-wise of
  the plain version in float32 math (the candidates printed), and at
  chunk 16 within 1e-2 of ``jax.grad`` of ``ssd_chunked``.

* K7 (RMSNorm) gives one warp to a row: lane l sums f·f with fmaf over the
  16-byte vectors l, l + 32, … of the row (8 bf16 or 4 float32 values;
  single values where D or the pointers do not allow 16-byte loads), in
  vector order, and the 32 lane partials meet in a shuffle butterfly
  (xor 16, 8, 4, 2, 1) (``csrc/rmsnorm.cu``).  :func:`_k7_lane_order`
  emulates that order in float32 torch: within 1e-5 of the float64 plain
  version for float32 x, within one bf16 ulp of each value of the plain
  version for bf16 x, at D 2048 and 4096 (the serving widths), 1536 and
  5120 (other Mamba2 sizes' widths; the rows kernel pads a lane's last
  vectors with zeros, or at 5120 float32 the two-pass kernel), 37 and 100
  (100 is vectorised for float32 and scalar for bf16).

And the FP32 guard of the structured path (C1): the region-mass product,
the structured movement's quadratic form and the objective-set
scalarization ask :func:`require_fp32_matmul`, which refuses card tensors
while TF32 matmuls are on.

The emulation helpers live here, on no path of the port.
"""

import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels.edge_latency import edge_latency_pallas  # noqa: E402
from repro_torch.core import OBJECTIVES, ObjectiveSet, RegionFleet  # noqa: E402
from repro_torch.core import torchmodel  # noqa: E402
from repro_torch.core import objectives as objectives_module  # noqa: E402
from repro_torch.core.graph import random_dag  # noqa: E402
from repro_torch.core.placement import random_placement  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.sim import BatchedEvaluator, pack_region_fleets  # noqa: E402
from repro_torch.sim import batched  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
try:
    import chip_smoke  # noqa: E402
finally:
    sys.path.pop(0)

REL = 1e-5
BF16_REL = 1e-2
STAGE_V = 32        # csrc/edge_latency.cu's STAGE_V
ATTN_BK = 64        # csrc/flash_attention.cu's tc::BK


# -- K1: split TF32 -------------------------------------------------------------

def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 → float32 rounded to TF32's 10 explicit mantissa bits,
    to nearest with ties away from zero (``cvt.rna.tf32.f32``): add half a
    TF32 ulp to the magnitude bits, then mask the low 13."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a: np.ndarray):
    hi = _tf32(a)
    lo = _tf32(a - hi)                        # a − hi is exact in float32
    return hi.astype(np.float64), lo.astype(np.float64)


def _f32_toward_zero(x: np.ndarray) -> np.ndarray:
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _split_tf32_product(xj: np.ndarray, com: np.ndarray,
                        staged: bool = True) -> np.ndarray:
    """(R, V) x_j and (U, V) com → (R, U) float32 ``x_j @ comᵀ`` as K1 sums
    it (see the module docstring); ``staged=False`` is the single
    accumulator the stage sums replace."""
    V = xj.shape[1]
    vp = -(-V // STAGE_V) * STAGE_V           # v >= V reads as 0
    ahi, alo = _split(np.pad(xj, ((0, 0), (0, vp - V))))
    bhi, blo = _split(np.pad(com, ((0, 0), (0, vp - V))))
    total = np.zeros((xj.shape[0], com.shape[0]), np.float32)
    acc = total.copy()
    for v0 in range(0, vp, STAGE_V):
        if staged:
            acc[:] = 0.0
        for k0 in range(v0, v0 + STAGE_V, 8):
            k = slice(k0, k0 + 8)
            for a, b in ((alo, bhi), (ahi, blo), (ahi, bhi)):
                acc = _f32_toward_zero(acc + a[:, k] @ b[:, k].T)
        if staged:
            total = (total.astype(np.float64) + acc).astype(np.float32)
    return total if staged else acc


def _serving_rows(seed: int, rows: int, V: int):
    """x_i, x_j (1, rows, V): placements as chip_smoke.py makes them (each
    row on ~5 % of the devices with exponential weights, summing to 1; x_i
    scaled by a selectivity) and com (1, V, V): 8 regions' costs with
    lognormal per-link jitter, 0 on the diagonal."""
    rng = np.random.default_rng(seed)

    def place():
        w = rng.exponential(1.0, (rows, V)) * (rng.random((rows, V)) < 0.05)
        w[np.arange(rows), rng.integers(0, V, rows)] += 1.0
        return (w / w.sum(-1, keepdims=True)).astype(np.float32)

    x_i = place() * np.float32(0.7)
    x_j = place()
    region = rng.integers(0, 8, V)
    base = rng.uniform(0.5, 4.0, (8, 8))
    base = (base + base.T) / 2
    com = (base[region][:, region]
           * rng.lognormal(0.0, 0.25, (V, V))).astype(np.float32)
    np.fill_diagonal(com, 0.0)
    return x_i[None], x_j[None], com[None]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def serving_k1():
    """The emulated K1 outputs (staged and single-accumulator), the float64
    oracle and the Pallas kernel in interpret mode at V 4096, 64 rows."""
    x_i, x_j, com = _serving_rows(16, 64, 4096)
    oracle = ref.edge_latency_dense_plain(
        *(torch.from_numpy(a).double() for a in (x_i, x_j, com))).numpy()
    pallas = np.asarray(edge_latency_pallas(
        *(jnp.asarray(a) for a in (x_i, x_j, com)), interpret=True))
    out = {}
    for staged in (True, False):
        t = _split_tf32_product(x_j[0], com[0], staged)
        out[staged] = (x_i[0] * t).max(-1)[None]
    return out, oracle, pallas


def test_tf32_rounding_and_split_are_exact_where_they_must_be():
    """hi keeps 11 significant bits, a − hi is exact, and hi + lo is within
    2^-21 of a (the residual after two 11-bit pieces, rounded)."""
    a = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi = _tf32(a)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(hi - a) <= np.abs(a) * 2.0 ** -11)
    h64, l64 = _split(a)
    assert np.all(np.abs(h64 + l64 - a) <= np.abs(a) * 2.0 ** -21)
    assert _tf32(np.float32([1.0 + 2.0 ** -11]))[0] == 1.0 + 2.0 ** -10


@pytest.mark.parametrize("against", ["float64", "pallas_interpret"])
def test_k1_split_tf32_emulation_meets_the_bar_at_serving_v(serving_k1,
                                                            against):
    """Staged split TF32 at V 4096 within 1e-5 of the float64 oracle and
    of the Pallas kernel.  Margin: the bar is held at a quarter of 1e-5
    (2.5e-6), the point under which ROADMAP's design keeps the stage sums
    unneeded, so the emulation's truncating model leaves room for the
    card's own accumulation."""
    out, oracle, pallas = serving_k1
    want = oracle if against == "float64" else pallas
    assert _rel(out[True], want) <= REL / 4


def test_k1_stage_sums_are_no_worse_than_one_accumulator(serving_k1):
    """Under the truncating model the single accumulator drifts with its
    running sum; the 32-deep stage sums bound each truncation to one
    stage.  Both are reported against float64 (the card measures the
    same pair in chip_smoke.py's K1 line)."""
    out, oracle, _ = serving_k1
    staged, single = _rel(out[True], oracle), _rel(out[False], oracle)
    print(f"K1 emulation vs float64 at V 4096: staged {staged:.3e}, "
          f"single accumulator {single:.3e}")
    assert staged <= single


@pytest.mark.parametrize("V", [7, 129, 300])
def test_k1_split_tf32_emulation_on_signed_operands(V):
    """chip_smoke.py's small signed cases (randn): normwise within 1e-5 of
    float64, staged and ragged (V not a multiple of 8 or 32)."""
    rng = np.random.default_rng(V)
    x_i, x_j, com = (rng.standard_normal(s).astype(np.float32)
                     for s in ((33, V), (33, V), (V, V)))
    got = (x_i * _split_tf32_product(x_j, com)).max(-1)
    want = ref.edge_latency_dense_plain(
        *(torch.from_numpy(a[None]).double() for a in (x_i, x_j, com)))
    assert _rel(got, want.numpy()[0]) <= REL


# -- K5: p rounded to bf16 ---------------------------------------------------------

def _attention_p_bf16(q, k, v, causal: bool) -> torch.Tensor:
    """K5's bf16 route in float32 math: 64-key tiles in ascending order, an
    online softmax in base 2 with f32 m and l, each weight p rounded to
    bf16 once against its tile's running max, l summing the rounded
    weights, p·v exact products summed in f32, ``acc / max(l, 1e-30)``
    rounded to bf16."""
    B, S, H, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B,H,S,D)
    scale = float(np.float32(D ** -0.5 * 1.4426950408889634))
    m = torch.full((B, H, S, 1), ref.ATTN_NEG)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, Skv, ATTN_BK):
        kt, vt = kf[:, :, k0:k0 + ATTN_BK], vf[:, :, k0:k0 + ATTN_BK]
        s = (qf @ kt.transpose(-1, -2)) * scale
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            s = s.masked_fill(kpos > qpos, ref.ATTN_NEG)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn).bfloat16().float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vt
        m = mn
    out = acc / l.clamp_min(ref.ATTN_L_FLOOR)
    return out.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("B,S,H,D", [(1, 128, 1, 64), (2, 96, 3, 32),
                                     (1, 256, 2, 128), (1, 100, 2, 64),
                                     (2, 100, 2, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_k5_rounded_p_stays_within_bf16_bar(B, S, H, D, causal):
    rng = np.random.default_rng(B * S + H + D)
    arrs = [torch.from_numpy(rng.standard_normal((B, S, H, D))
                             .astype(np.float32)).bfloat16()
            for _ in range(3)]
    got = _attention_p_bf16(*arrs, causal)
    plain = ref.flash_attention_plain(*arrs, causal=causal)
    pallas = ops.flash_attention(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in arrs),
        causal=causal, interpret=True)
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    assert _rel(got.float(), plain.float()) <= BF16_REL
    assert _rel(got.float(), np.asarray(pallas, np.float32)) <= BF16_REL


# -- K6: the chunk-parallel passes and their bf16 operands ------------------------

def _ssd_args(b, L, H, P, N, seed, slow, dtype=torch.float32):
    """x, B, C (b, L, ·) rounded to ``dtype``, dt, A, D float32, from numpy:
    tests/test_kernels.py's distributions, or with ``slow`` decay (dt =
    softplus(z − 6), A = −0.05·(1 + 0.1u))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P))
    B, C = (rng.standard_normal((b, L, N)) * 0.5 for _ in range(2))
    if slow:
        dt = np.logaddexp(rng.standard_normal((b, L, H)) - 6.0, 0)
        A = -0.05 * (1.0 + 0.1 * rng.random(H))
    else:
        dt = np.logaddexp(rng.standard_normal((b, L, H)), 0) * 0.5
        A = -np.exp(rng.standard_normal(H) * 0.3)
    D = rng.standard_normal(H)
    t = [torch.from_numpy(a.astype(np.float32)) for a in (x, B, C, dt, A, D)]
    return [*(a.to(dtype) for a in t[:3]), *t[3:]]


@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("b,L,H,P,N,chunk", [
    (2, 128, 3, 8, 16, 16), (1, 250, 2, 16, 32, 32), (1, 100, 2, 8, 8, 256),
    (2, 20, 5, 8, 16, 8)])
def test_k6_three_passes_equal_the_plain_version(b, L, H, P, N, chunk,
                                                 slow):
    """Chunk states, state passing and output in float64 give the plain
    version's y within 1e-12 (ragged L = 250, 20; one chunk at L = 100)."""
    args = [a.double() for a in _ssd_args(b, L, H, P, N, L + H, slow)]
    got = chip_smoke.ssd_three_pass(torch, *args, chunk)
    want = ref.ssd_scan_plain(*args, chunk)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("slow", [False, True])
def test_k6_rounded_operands_stay_within_bf16_bar(slow):
    """bf16 inputs over 8 chunks of 16 rows: the kernel's rounding (w ⊙ x,
    M, S to bf16 once, y to bf16) within 1e-2 of the plain version in
    float32 math and of the Pallas kernel in interpret mode."""
    args = _ssd_args(1, 128, 4, 16, 16, 7, slow, torch.bfloat16)
    got = chip_smoke.ssd_three_pass(torch, *args, 16, "bf16")
    plain = ref.ssd_scan_plain(*args, 16)
    pallas = ops.ssd_scan(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                            for a in args[:3]),
                          *(jnp.asarray(a.numpy()) for a in args[3:]),
                          chunk=16, head_block=2, interpret=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), plain.float()) <= BF16_REL
    assert _rel(got.float(), np.asarray(pallas, np.float32)) <= BF16_REL


@pytest.mark.parametrize("slow", [False, True])
def test_k6_numerics_candidates_at_a_serving_like_shape(slow):
    """b 1, L 2048 (8 chunks of 256), 8 heads of 64, N 128, x/B/C in bf16:
    each candidate for the three rounded operands against the plain
    version, both in float32 math (no output rounding), and, rounded to a
    bf16 y as the kernel writes it, against the plain version's bf16 y
    within the 1e-2 bar.  hi + lo and TF32 are never worse than bf16
    once.  The numbers are printed (csrc/ssd_scan.cu's header quotes
    them)."""
    args = _ssd_args(1, 2048, 8, 64, 128, 3, slow, torch.bfloat16)
    f32 = [a.float() for a in args]
    want32 = ref.ssd_scan_plain(*f32, 256)
    want = want32.bfloat16().float()
    errs, rounded = {}, {}
    for op in chip_smoke.SSD_CANDIDATES:
        got = chip_smoke.ssd_three_pass(torch, *f32, 256, op)
        errs[op] = _rel(got, want32)
        rounded[op] = _rel(got.bfloat16().float(), want)
    print(f"K6 candidates ({'slow' if slow else 'fast'} decay), float32 y: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; bf16 y: " + ", ".join(f"{k} {v:.3e}"
                                     for k, v in rounded.items()))
    assert max(rounded.values()) <= BF16_REL
    assert errs["bf16_hilo"] <= errs["bf16"] and errs["tf32"] <= errs["bf16"]


# -- K6's backward: the bf16 route's passes and their rounded operands ---------

def _ssd_bwd_args(b, L, H, P, N, seed, slow, dtype=torch.float32):
    """:func:`_ssd_args` and an upstream gradient dy (standard normal, in
    ``dtype``), from numpy."""
    args = _ssd_args(b, L, H, P, N, seed, slow, dtype)
    dy = np.random.default_rng(seed + 1).standard_normal((b, L, H, P))
    return args, torch.from_numpy(dy.astype(np.float32)).to(dtype)


def _norm_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("b,L,H,P,N,chunk", [
    (2, 128, 3, 8, 16, 16), (1, 250, 2, 16, 32, 32), (1, 100, 2, 8, 8, 256),
    (2, 20, 5, 8, 16, 8)])
def test_k6_backward_passes_equal_the_plain_version(b, L, H, P, N, chunk,
                                                    slow):
    """The bf16 route's passes (cumsums, chunk states, state passing, the
    chunk's gradients over a CTA's block of heads) in float64
    with nothing rounded give ``ssd_scan_bwd_plain``'s six gradients within
    1e-12 (ragged L = 250, 20; one chunk at L = 100; H 3 and 5, not
    multiples of a CTA's heads)."""
    args, dy = _ssd_bwd_args(b, L, H, P, N, L + H, slow)
    args, dy = [a.double() for a in args], dy.double()
    got = chip_smoke.ssd_bwd_passes(torch, *args, dy, chunk)
    want = ref.ssd_scan_bwd_plain(*args, dy, chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64 and g.shape == w.shape
        assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("slow", [False, True])
def test_k6_backward_numerics_candidates_at_a_training_like_shape(slow):
    """b 1, L 2048 (8 chunks of 256), 8 heads of 64, N 128, x/B/C/dy in
    bf16: each candidate for the six rounded operands (w ⊙ x, e ⊙ dy, M,
    dG, S_c, dS_{c+1}) against the plain version in float32 math, worst
    gradient norm-wise.  The kernel's choice, bf16 once, stays within
    5e-3 (half the 1e-2 bar); hi + lo and TF32 are never worse.  The
    numbers are printed (csrc/ssd_scan_bwd.cu's header quotes them)."""
    args, dy = _ssd_bwd_args(1, 2048, 8, 64, 128, 3, slow, torch.bfloat16)
    want = ref.ssd_scan_bwd_plain(*args, dy, 256)
    worst = {}
    for op in chip_smoke.SSD_CANDIDATES:
        got = chip_smoke.ssd_bwd_passes(torch, *args, dy, 256, op)
        assert [g.dtype for g in got] == [w.dtype for w in want]
        worst[op] = max(_norm_rel(g, w) for g, w in zip(got, want))
    alone = {k: max(_norm_rel(g, w) for g, w in zip(
        chip_smoke.ssd_bwd_passes(torch, *args, dy, 256, "bf16", (k,)),
        want)) for k in chip_smoke.SSD_BWD_ROUNDED}
    print(f"K6 backward candidates ({'slow' if slow else 'fast'} decay), "
          f"worst norm-wise gradient: " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + "; bf16 on one operand alone: " + ", ".join(
              f"{k} {v:.3e}" for k, v in alone.items()))
    assert worst["bf16"] <= 5e-3
    assert worst["bf16_hilo"] <= worst["bf16"]
    assert worst["tf32"] <= worst["bf16"]
    assert max(alone.values()) <= worst["bf16"]


def test_k6_backward_rounded_operands_match_jax_grad_at_chunk_16():
    """bf16 inputs, chunk 16 (where the reference's gradient is finite):
    the bf16 route's rounding of all six operands within 1e-2 (BF16_REL,
    max |err| / max |want|) of ``jax.grad`` of
    ``repro.models.mamba2.ssd_chunked`` on the same bf16 values."""
    import jax
    from repro.models.mamba2 import ssd_chunked
    args, dy = _ssd_bwd_args(1, 128, 4, 16, 16, 11, False, torch.bfloat16)
    got = chip_smoke.ssd_bwd_passes(torch, *args, dy, 16, "bf16")
    f32 = [a.float().numpy() for a in args]
    g32 = dy.float().numpy()

    def loss(*a):
        y, _ = ssd_chunked(*a, 16)
        return jnp.sum(y * g32)

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, f32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        assert _rel(g.float().numpy(), w) <= BF16_REL


# -- K7: the lane order of the sum of squares -----------------------------------

def _k7_lane_order(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x (rows, D) float32 or bf16, w (D,) float32 → K7's y, its sum of
    squares taken in the kernel's order (see the module docstring) in
    float32.  fmaf is the exact product f·f (exact in float64) plus the
    partial, rounded to float64 and then to float32: the kernel rounds
    once, so a partial may differ by one float32 ulp where the two
    roundings meet a tie."""
    rows, D = x.shape
    n = 16 // x.element_size()              # values per 16-byte vector
    width = n if D % n == 0 else 1
    steps = -(-(D // width) // 32)          # vectors per lane, rounded up
    xf = x.float()
    padded = torch.zeros(rows, steps * 32 * width, dtype=torch.float64)
    padded[:, :D] = xf.double()             # fmaf(0, 0, s) == s
    padded = padded.view(rows, steps, 32, width)
    ss = torch.zeros(rows, 32, dtype=torch.float32)
    for step in range(steps):               # lane l: vector step·32 + l
        for i in range(width):
            f = padded[:, step, :, i]
            ss = (f * f + ss.double()).float()
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        ss = ss + ss[:, lanes ^ off]
    assert torch.equal(ss, ss[:, :1].expand(rows, 32))   # every lane agrees
    inv = torch.rsqrt(ss[:, :1] / D + eps)
    return ((xf * inv) * w.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [2048, 4096, 37, 100, 1536, 5120])
def test_k7_lane_order_meets_the_bars(D, dtype):
    """float32 x: within 1e-5 of the float64 plain version; bf16 x: within
    one bf16 ulp of each value of the plain version (both round one
    float32 result)."""
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((16, D)).astype(np.float32)
                         * np.float32(3.0)).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    got = _k7_lane_order(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape
    if dtype == "float32":
        want = ref.rmsnorm_plain(x.double(), w.double())
        assert _rel(got.numpy(), want.numpy()) <= REL
    else:
        want = ref.rmsnorm_plain(x, w).float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got.float().numpy() - want) <= ulp)


# -- K7's backward: the order of its sums ----------------------------------------

_RMSNORM_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
               / "kernels" / "csrc" / "rmsnorm.cu")


def _cu_constants(*names) -> dict:
    """The integer ``constexpr`` constants ``names`` of ``csrc/rmsnorm.cu``
    (``constexpr int A = 1, B = 2;`` or one a line)."""
    import re
    text = _RMSNORM_CU.read_text()
    out = {}
    for name in names:
        m = re.search(rf"constexpr\s+(?:int|int64_t)\s+(?:\w+\s*=\s*\w+\s*,"
                      rf"\s*)*{name}\s*=\s*(\d+)", text)
        assert m, f"{name} not found in {_RMSNORM_CU.name}"
        out[name] = int(m.group(1))
    return out


def _cu_bwd_grid(rows: int, D: int, c: dict) -> int:
    """``rmsnorm_bwd_partials`` as ``csrc/rmsnorm.cu`` writes it (``bwd_grid``
    with C's integer division), from the constants parsed out of it."""
    if rows < 1 or D < 1:
        return 0
    spread = c["BWD_WIDE_D"] // D
    spread = 1 if spread < 1 else min(spread, c["BWD_SPREAD"])
    by_rows = (rows + c["BWD_MIN_ROWS"] - 1) // c["BWD_MIN_ROWS"]
    return min(by_rows, c["BWD_CTAS"] * spread)


def test_k7_backward_scratch_formula_is_the_sources():
    """``rmsnorm.bwd_partials`` (the wrapper sizes the dw scratch with it,
    no call into the library) equals ``csrc/rmsnorm.cu``'s ``bwd_grid``,
    whose constants are read from the source, over a grid of (rows, D)."""
    from repro_torch.kernels import rmsnorm as rk
    c = _cu_constants("BWD_MIN_ROWS", "BWD_CTAS", "BWD_WIDE_D",
                      "BWD_SPREAD", "BWD_MAX_D")
    assert (rk.BWD_MIN_ROWS, rk.BWD_CTAS, rk.BWD_WIDE_D, rk.BWD_SPREAD,
            rk.BWD_MAX_D) == (c["BWD_MIN_ROWS"], c["BWD_CTAS"],
                              c["BWD_WIDE_D"], c["BWD_SPREAD"],
                              c["BWD_MAX_D"])
    for rows in (0, 1, 7, 8, 9, 300, 2111, 2112, 2113, 8192, 22_528,
                 65_536, 1 << 20):
        for D in (0, 1, 37, 64, 100, 128, 255, 256, 257, 1024, 2047, 2048,
                  2049, 4096, 7168, 8192):
            assert rk.bwd_partials(rows, D) == _cu_bwd_grid(rows, D, c), \
                (rows, D)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf on float32 tensors: a·b exact in float64, plus c, rounded to
    float64 and then to float32 (the kernel rounds once, so a result may
    differ by one ulp where the two roundings meet a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _k7_bwd_layout(D: int, dtype: torch.dtype, c: dict):
    """(values a load, loads a row, threads a CTA, loads a thread) of the
    backward for rows of D elements of ``dtype`` with 16-byte aligned
    operands: the ring's 16-byte vectors where D allows (up to BWD_BT × 4
    of them), else the scalar rows, one element a load."""
    n = 16 // torch.empty((), dtype=dtype).element_size()
    width = n if D % n == 0 and D // n <= c["BWD_BT"] * 4 else 1
    nv = D // width
    bt = c["BWD_BT"] if nv >= c["BWD_BT"] else -(-nv // 32) * 32
    return width, nv, bt, -(-nv // bt)


def _k7_bwd_order(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-6, chunk: int = 512):
    """x, g (rows, D) float32 or bf16, w (D,) float32 → (dx in x's dtype,
    dw float32) with every sum in ``csrc/rmsnorm.cu``'s backward order:
    thread t of a CTA of BT sums f·f and f·(g·w) with fmaf over its loads
    k = t, t + BT, ... and their values in order; the 32 lanes of a warp
    meet in the xor butterfly; the warps' sums are added in warp order.
    dw: CTA b of G = ``bwd_grid`` takes rows b, b + G, b + 2G, ... and sums
    g·(x·r) with fmaf row by row into its partial row; with SL =
    min(G, DW_SLICES) slices, slice s adds the partials p = s, s + SL, ...
    in order, then the slices are added in order.  Rows in chunks of
    ``chunk`` (8192 × 8192 in float64 would take gigabytes)."""
    from repro_torch.kernels import rmsnorm as rk
    c = _cu_constants("BWD_BT", "DW_SLICES")
    rows, D = x.shape
    width, nv, bt, NV = _k7_bwd_layout(D, x.dtype, c)
    nw = bt // 32
    lanes = torch.arange(32)
    wf = w.float()
    r_all = torch.empty(rows, dtype=torch.float32)
    dx = torch.empty_like(x)
    for a in range(0, rows, chunk):
        xf, gf = x[a:a + chunk].float(), g[a:a + chunk].float()
        R = xf.shape[0]
        pad = torch.zeros(R, NV * bt * width, dtype=torch.float32)
        xp, gwp = pad.clone(), pad.clone()
        xp[:, :D] = xf
        gwp[:, :D] = gf * wf                  # the float32 product g·w
        xp, gwp = (t.view(R, NV, bt, width) for t in (xp, gwp))
        ss = torch.zeros(R, bt, dtype=torch.float32)
        sg = torch.zeros(R, bt, dtype=torch.float32)
        for j in range(NV):                   # thread t: load j·BT + t
            for i in range(width):
                f = xp[:, j, :, i]
                ss = _fma(f, f, ss)
                sg = _fma(f, gwp[:, j, :, i], sg)
        sums = []
        for s in (ss, sg):
            s = s.view(R, nw, 32)
            for off in (16, 8, 4, 2, 1):
                s = s + s[..., lanes ^ off]
            assert torch.equal(s, s[..., :1].expand(R, nw, 32))
            tot = torch.zeros(R, dtype=torch.float32)
            for i in range(nw):               # the warps in order
                tot = tot + s[:, i, 0]
            sums.append(tot)
        r = torch.rsqrt(sums[0] / D + eps)
        cc = (sums[1] / D) * r * r * r
        r_all[a:a + R] = r
        dx[a:a + R] = (r[:, None] * (gf * wf)
                       - xf * cc[:, None]).to(x.dtype)
    G = rk.bwd_partials(rows, D)
    b = torch.arange(G)
    part = torch.zeros(G, D, dtype=torch.float32)
    for step in range(-(-rows // G)):         # CTA b: rows b, b + G, ...
        live = b + step * G < rows
        idx = (b + step * G)[live]
        xf, gf = x[idx].float(), g[idx].float()
        part[live] = _fma(gf, xf * r_all[idx][:, None], part[live])
    sl = min(G, c["DW_SLICES"])
    dw = torch.zeros(D, dtype=torch.float32)
    for s in range(sl):
        a_s = torch.zeros(D, dtype=torch.float32)
        for p in range(s, G, sl):
            a_s = a_s + part[p]
        dw = dw + a_s
    return dx, dw


def _plain_bwd_chunked(x, w, g, wide: bool, chunk: int = 512):
    """``ref.rmsnorm_bwd_plain`` over row chunks (dw summed in float64):
    in float64 (``wide``) or in float32 math on x's dtype."""
    dxs, dw = [], torch.zeros(x.shape[1], dtype=torch.float64)
    for a in range(0, x.shape[0], chunk):
        xs, gs = x[a:a + chunk], g[a:a + chunk]
        if wide:
            xs, gs, ws = xs.double(), gs.double(), w.double()
        else:
            ws = w
        d, dwc = ref.rmsnorm_bwd_plain(xs, ws, gs)
        dxs.append(d)
        dw += dwc.double()
    return torch.cat(dxs), dw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 7, 300, 8192])
@pytest.mark.parametrize("D", [37, 100, 2048, 4096, 7168, 8192])
def test_k7_backward_order_meets_the_bars(D, rows, dtype):
    """The backward's summation orders (:func:`_k7_bwd_order`) at the card
    tests' bars: float32 dx within 1e-5 of the float64 plain version, bf16
    dx within one bf16 ulp of the largest (1e-2) of the plain version on
    the same operands, dw within 1e-4 of the float64 plain version."""
    rng = np.random.default_rng(rows * 10_007 + D)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((rows, D), np.float32)).to(td)
    g = torch.from_numpy(rng.standard_normal((rows, D), np.float32)).to(td)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(D, np.float32))
    dx, dw = _k7_bwd_order(x, w, g)
    assert dx.dtype == td and dx.shape == x.shape and dw.dtype == torch.float32
    wide_dx, wide_dw = _plain_bwd_chunked(x, w, g, wide=True)
    want_dx = wide_dx if dtype == "float32" else \
        _plain_bwd_chunked(x, w, g, wide=False)[0]
    bar = REL if dtype == "float32" else BF16_REL
    assert _rel(dx.double().numpy(), want_dx.double().numpy()) <= bar
    assert _rel(dw.double().numpy(), wide_dw.numpy()) <= 1e-4


# -- C1: the FP32 guard of the structured path ------------------------------------

def _structured_instance(seed: int):
    rng = np.random.default_rng(seed)
    g = random_dag(5, 0.5, rng)
    region = rng.integers(0, 3, 6)
    fleets = []
    for _ in range(2):
        inter = rng.uniform(0.1, 2.0, (3, 3))
        fleets.append(RegionFleet(region=region, inter=(inter + inter.T) / 2,
                                  degrade=rng.uniform(1.0, 3.0, 6)))
    xs = np.stack([random_placement(5, np.ones((5, 6), bool), rng)
                   for _ in range(3)])
    return g, fleets, xs


def _recorder(monkeypatch, module):
    seen = []
    real = module.require_fp32_matmul

    def record(t, what):
        seen.append(what)
        real(t, what)

    monkeypatch.setattr(module, "require_fp32_matmul", record)
    return seen


def test_structured_score_grid_consults_the_fp32_guard(monkeypatch):
    seen = _recorder(monkeypatch, torchmodel)
    g, fleets, xs = _structured_instance(1)
    BatchedEvaluator(g, device="cpu").score_grid(
        xs, pack_region_fleets(fleets))
    assert "the structured region masses" in seen


def test_scalarization_consults_the_fp32_guard(monkeypatch):
    seen = _recorder(monkeypatch, batched)
    g, fleets, xs = _structured_instance(2)
    BatchedEvaluator(g, device="cpu").score_grid(
        xs, pack_region_fleets(fleets),
        objectives=ObjectiveSet.of(*OBJECTIVES))
    assert seen == ["the objective-set scalarization"]


def test_structured_movement_consults_the_fp32_guard(monkeypatch):
    """The weighted movement's quadratic form asks the guard itself, not
    only through the region masses it reads."""
    seen = _recorder(monkeypatch, objectives_module)
    g, fleets, xs = _structured_instance(3)
    BatchedEvaluator(g, device="cpu").score_grid(
        xs, pack_region_fleets(fleets),
        objectives=ObjectiveSet.of(*OBJECTIVES))
    assert "the movement objectives" in seen


def test_fp32_guard_refuses_card_tensors_while_tf32_is_on():
    """The guard reads both process-wide switches; CPU tensors pass."""
    card = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = torch.zeros(1)
    was_tf32 = torch.backends.cuda.matmul.allow_tf32
    was_prec = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torchmodel.require_fp32_matmul(card, "x")
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full-FP32"):
            torchmodel.require_fp32_matmul(card, "the region masses")
        torchmodel.require_fp32_matmul(cpu, "x")
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="the scalarization need"):
            torchmodel.require_fp32_matmul(card, "the scalarization")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was_tf32
        torch.set_float32_matmul_precision(was_prec)
