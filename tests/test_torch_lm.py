"""The port's dense decoder (OLMo-1B) against the JAX package's
``DecoderLM`` on the same parameters and tokens, plus its layers, config
registry, accounting and parameter converter.

Parameters come from the JAX model's ``init_params`` and cross over as
numpy arrays (``convert.decoder_lm_from_arrays``); tokens are drawn with
numpy.  Tolerances, relative as max |err| / max |want| of the logits:

* float32 activations: ≤1e-5.  Both sides compute every op in float32 in a
  different summation order; measured ≤1.5e-6.
* bfloat16 activations: ≤2e-2.  Each side rounds every activation to
  bfloat16 at its own places (XLA's and PyTorch's silu and matmul round
  differently in the last bit), and a two-layer stack carries those
  one-ulp differences into the logits; the worst case measured here was
  1.54e-2 (S = 256, flash route).
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.api import analytic_flops as jax_flops  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import count_params as jax_count  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (analytic_flops, build_model,  # noqa: E402
                                count_params, layers)
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 2e-2}
# the JAX route each port route is held against
ROUTES = [("pallas", "pallas_interpret"), ("reference", "reference")]
# GQA (4 query heads on 2 kv heads), RMSNorm with weights, qk-norm, GELU
VARIANT = dict(norm_type="rmsnorm", qk_norm=True, mlp_kind="gelu",
               n_kv_heads=2)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _port_config(jcfg, impl: str) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    fields["attention_impl"] = impl
    return ModelConfig(**fields)


@functools.lru_cache(maxsize=None)
def _jax_params(act: str, variant: bool):
    cfg = jax_smoke("olmo_1b").replace(act_dtype=act)
    if variant:
        cfg = cfg.replace(**VARIANT)
    params = jax_build(cfg).init_params(jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _forward_pair(port_impl, jax_impl, act, S, variant=False):
    cfg, params, tree = _jax_params(act, variant)
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S))
    jcfg = cfg.replace(attention_impl=jax_impl)
    want, _ = jax_build(jcfg).forward(params,
                                      {"tokens": jnp.asarray(toks, jnp.int32)})
    model = convert.decoder_lm_from_arrays(_port_config(cfg, port_impl), tree,
                                           device="cpu")
    with torch.inference_mode():
        got, aux = model({"tokens": toks})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, S, cfg.vocab_padded)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("port_impl,jax_impl", ROUTES)
@pytest.mark.parametrize("S", [16, 256])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_matches_jax(port_impl, jax_impl, S, act):
    got, want = _forward_pair(port_impl, jax_impl, act, S)
    assert _rel(got, want) <= REL[act]


@pytest.mark.parametrize("port_impl,jax_impl", ROUTES)
def test_gqa_rmsnorm_variant_matches_jax(port_impl, jax_impl):
    got, want = _forward_pair(port_impl, jax_impl, "float32", 48,
                              variant=True)
    assert _rel(got, want) <= REL["float32"]


def test_full_config_and_accounting_match_jax():
    jcfg = jax_config("olmo_1b")
    cfg = get_config("olmo-1b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_smoke_config("olmo_1b")) == \
        dataclasses.asdict(jax_smoke("olmo_1b"))
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_padded) == (16, 2048, 16, 128, 8192, 50432)
    assert (cfg.pdtype, cfg.adtype) == (torch.float32, torch.bfloat16)
    assert count_params(cfg) == jax_count(jcfg)
    for mode in ("train", "prefill", "decode"):
        assert analytic_flops(cfg, 2048, 128, mode) == \
            jax_flops(jcfg, 2048, 128, mode)


def test_registry_and_builder_refuse_what_is_not_ported(monkeypatch):
    """Every architecture of the reference's registry is ported now: the
    registry and the builder refuse only what the reference refuses (an
    unknown arch, a family without its sizes, an unknown attention
    route, the card where there is none)."""
    assert dataclasses.asdict(get_config("arctic-480b")) == \
        dataclasses.asdict(jax_config("arctic_480b"))
    assert dataclasses.asdict(get_config("zamba2-1.2b")) == \
        dataclasses.asdict(jax_config("zamba2_1_2b"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("gpt-5")
    smoke = get_smoke_config("olmo_1b")
    with pytest.raises(ValueError, match="shared_attn_every"):
        build_model(smoke.replace(family="hybrid"), device="cpu")
    with pytest.raises(ValueError, match="cross_attn_every"):
        build_model(smoke.replace(family="vlm"), device="cpu")
    with pytest.raises(ValueError, match="encoder_layers"):
        build_model(smoke.replace(family="audio"), device="cpu")
    moe = build_model(smoke.replace(moe_experts=4), device="cpu")
    assert hasattr(moe.blocks[0], "moe") and not hasattr(moe.blocks[0],
                                                         "mlp")
    with pytest.raises(ValueError, match="attention impl"):
        model = build_model(smoke.replace(attention_impl="pallas_interpret"),
                            device="cpu")
        model.init_params(torch.Generator().manual_seed(0))
        model({"tokens": np.zeros((1, 4), np.int64)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(smoke)


def test_init_params_is_seeded_and_scaled():
    cfg = get_smoke_config("olmo_1b")
    a = DecoderLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    b = DecoderLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    # the reference's scales: normal × fan_in^-½
    assert abs(float(a.embed.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    wo = a.blocks[0].mlp["wo"]
    assert abs(float(wo.std()) * cfg.d_ff ** 0.5 - 1) < 0.1
    assert a.final_norm is None and a.blocks[0].ln1 is None


def test_converter_refuses_a_mismatched_tree():
    cfg, _, tree = _jax_params("float32", False)
    port = _port_config(cfg, "pallas")
    bad = dict(tree, head=tree["head"][:, :-1])
    with pytest.raises(ValueError, match="head: shape"):
        convert.decoder_lm_from_arrays(port, bad, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        convert.decoder_lm_from_arrays(port.replace(n_layers=3), tree,
                                       device="cpu")
    with pytest.raises(ValueError, match="not a dense DecoderLM tree"):
        convert.decoder_lm_from_arrays(port, dict(tree, extra=1),
                                       device="cpu")


# ------------------------------------------------------------- layers -----

def _arr(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    x = _arr((3, 5, 64), 1)
    w = _arr((64,), 2)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        layers.rms_norm(tx, torch.from_numpy(w)).float().numpy(),
        np.asarray(jax_layers.rms_norm(jx, jnp.asarray(w)), np.float32),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        layers.apply_norm("layernorm_nonparam", tx, None, eps=0.3)
        .float().numpy(),
        np.asarray(jax_layers.apply_norm("layernorm_nonparam", jx, None,
                                         eps=0.3), np.float32),
        rtol=tol, atol=tol)


def test_rotary_and_embedding_match_jax():
    cos, sin = layers.rotary_embedding(torch.arange(40), 16, 1e4)
    jcos, jsin = jax_layers.rotary_embedding(jnp.arange(40), 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)
    x = _arr((2, 40, 3, 16), 3)
    np.testing.assert_allclose(
        layers.apply_rotary(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jax_layers.apply_rotary(jnp.asarray(x), jcos, jsin)),
        atol=2e-5)
    table = _arr((300, 8), 4)
    toks = np.random.default_rng(5).integers(0, 300, (2, 600))
    got = layers.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks),
                              torch.bfloat16)
    want = jax_layers.embed_lookup(jnp.asarray(table), jnp.asarray(toks),
                                   jnp.bfloat16)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal):
    """150 queries in chunks of 64: the reference pads the last chunk."""
    q, k, v = (_arr((2, 150, 2, 16), s) for s in (6, 7, 8))
    got = layers._sdpa_chunked(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, chunk=64)
    want = jax_layers._sdpa_chunked(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, q_offset=0, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_cross_entropy_matches_jax():
    logits = _arr((2, 7, 50), 9) * 3
    labels = np.random.default_rng(10).integers(0, 50, (2, 7))
    mask = (np.random.default_rng(11).random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = layers.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        want = jax_layers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
