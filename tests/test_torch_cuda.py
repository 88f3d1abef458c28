"""Tests that need a CUDA card: the port's kernels against their plain
versions on the card.  They skip without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX (the card's machine has none), and the
card is looked for inside a fixture, never at import."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

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
