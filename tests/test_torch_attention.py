"""K5, flash attention: the plain PyTorch version against the JAX package's
Pallas kernel run in interpret mode (``repro.kernels.ops.flash_attention``),
at the tests/test_kernels.py shapes plus a ragged S, causal and full, float32
and bfloat16; the device route and the kernel wrapper's refusals.

Tolerances are the JAX sweep's own (tests/test_kernels.py): atol 2e-5 for
float32, atol 3e-2 with rtol 1e-2 for bfloat16 (both sides compute in
float32 and round the output to bfloat16; the Pallas kernel sums per
128-block, the plain version in one pass).  The CUDA kernel itself has no
CPU mode: ``chip_smoke.py`` holds it against the plain version on the card,
and so does ``tests/test_torch_cuda.py`` where a card is present."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=1e-2),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}
SHAPES = [(1, 128, 1, 64), (2, 128, 4, 64), (1, 256, 2, 128),
          (2, 96, 3, 32), (1, 384, 2, 64), (2, 100, 2, 16)]


def _inputs(B, S, H, D, dtype, seed):
    """q, k, v drawn with numpy, rounded to ``dtype`` once, as float32
    arrays both sides start from."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


@pytest.mark.parametrize("B,S,H,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret(B, S, H, D, dtype, causal):
    arrs = _inputs(B, S, H, D, dtype, seed=B * S + H)
    want = ops.flash_attention(*(jnp.asarray(a, dtype) for a in arrs),
                               causal=causal, interpret=True)
    got = ref.flash_attention_plain(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
        causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_dispatch_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU tensor reached the CUDA kernel wrapper")

    monkeypatch.setattr(fa, "flash_attention", refuse)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 2, 32, "float32",
                                                    seed=3))
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    try:
        before = reg.value("kernels.dispatch.plans", kind="flash_attention",
                           impl="plain")
        out = dispatch.flash_attention(q, k, v, causal=True)
        assert reg.value("kernels.dispatch.plans", kind="flash_attention",
                         impl="plain") == before + 1
    finally:
        reg.enabled = was
    assert torch.equal(out, ref.flash_attention_plain(q, k, v, causal=True))
    assert fa.launches == {"flash_attention": 0}


def test_causal_needs_equal_query_and_key_lengths():
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 12, 2, 16))
    with pytest.raises(ValueError, match="Sq == Skv"):
        dispatch.flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa.flash_attention(q, kv, kv, causal=True)
    # full attention over more keys than queries is fine on the CPU route
    assert dispatch.flash_attention(q, kv, kv, causal=False).shape == q.shape


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="repeat kv"):
        dispatch.flash_attention(x, torch.zeros((1, 8, 1, 16)),
                                 torch.zeros((1, 8, 1, 16)))
    with pytest.raises(TypeError, match="dtypes differ"):
        dispatch.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="span devices"):
        dispatch.flash_attention(x, x, torch.empty((1, 8, 2, 16),
                                                   device="meta"))
    with pytest.raises(ValueError, match="no flash-attention route"):
        dispatch.plan_attention_kernel(torch.empty(1, device="meta"))
    assert fa.launches == {"flash_attention": 0}


def test_plain_version_masks_causally_from_position_zero():
    """Row 0 of causal attention sees only key 0, so it returns v[0]
    exactly; full attention over equal scores averages v."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 1, 16))
                                .astype(np.float32)) for _ in range(3))
    out = ref.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(out[:, 0], v[:, 0])
    flat = ref.flash_attention_plain(torch.zeros_like(q), k, v, causal=False)
    torch.testing.assert_close(flat[0, 3], v[0].mean(0), rtol=0, atol=1e-6)


def test_attention_roofline_counts_the_pairs_the_mask_keeps():
    t = roofline.flash_attention_terms(11, 2048, 16, 128, torch.bfloat16,
                                       causal=True)
    assert t.flops == 4 * 11 * 16 * 128 * 2048 * 2049 / 2
    assert t.bytes == 4 * 11 * 2048 * 16 * 128 * 2
    assert t.compute_s == t.flops / 989e12 and t.bound_by == "operations"
    f = roofline.flash_attention_terms(1, 64, 1, 64, "float32", causal=False)
    assert f.flops == 4 * 64 ** 3 and f.compute_s == f.flops / 67e12
    assert f.memory_s == 4 * 64 * 64 * 4 / 3.35e12 and f.bound_by == "bytes"
    with pytest.raises(ValueError, match="no attention peak"):
        roofline.flash_attention_terms(1, 8, 1, 16, torch.float16, True)
