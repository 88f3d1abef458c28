"""The port's cross-attention and Llama-3.2-Vision-style VLM against the
JAX package on the CPU: ``attention`` with ``kv_source`` and with the
precomputed keys and values of a cache, the smoke forward (both attention
routes) with non-zero gates, a config whose layers do not divide
``cross_attn_every``, prefill and teacher-forced decode with every cache
leaf, bfloat16 activations over float32 parameters (the float32-promoted
cross keys and values), ``serve_wave`` with ``image_embeds``, a decode
from the reference's prefill, the converter, and the rehearsals of
``chip_smoke.py``'s VLM phases.

The gates start at 0 in both packages, which would leave the cross path
unchecked: every model here loads gates of 0.8, -0.5, 0.3 through the
converter.

Bars: float32 outputs, logits and cache leaves ≤1e-5 relative (max |err| /
max |want|) to JAX's; bfloat16 activations ≤1e-2; greedy tokens equal.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.vlm import VisionLM, VLMCache  # noqa: E402

ARCH = "llama_3_2_vision_11b"
REL = {"float32": 1e-5, "bfloat16": 1e-2}
GATES = (0.8, -0.5, 0.3)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


@functools.lru_cache(maxsize=None)
def _models(layers_: int = 4, act: str = "float32",
            impl: str = "reference"):
    """The JAX smoke VLM (``layers_`` layers, cross every 2), its
    parameters with non-zero gates, and the port's model holding them."""
    jcfg = jax_smoke(ARCH).replace(n_layers=layers_, act_dtype=act)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    n_cross = jmodel.n_cross
    params["cross"]["gate"] = jnp.asarray(GATES[:n_cross], jnp.float32)
    cfg = ModelConfig(**dataclasses.asdict(jcfg)).replace(
        attention_impl=impl)
    model = convert.vision_lm_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jmodel, params, cfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _image(cfg, B, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _attn_params(seed, d=64, H=8, K=2, hd=8):
    rng = np.random.default_rng(seed)
    return {"wq": rng.standard_normal((d, H * hd)) * d ** -0.5,
            "wk": rng.standard_normal((d, K * hd)) * d ** -0.5,
            "wv": rng.standard_normal((d, K * hd)) * d ** -0.5,
            "wo": rng.standard_normal((H * hd, d)) * (H * hd) ** -0.5}


@pytest.mark.parametrize("Sq", [1, 5, 300])
@pytest.mark.parametrize("K", [2, 8])
def test_attention_with_kv_source_matches_jax(K, Sq):
    """Keys and values from the source, no rotary, not causal; the chunked
    attention over 300 queries (two chunks) and a one-token query (the
    grouped einsum when K < H)."""
    p = {k: v.astype(np.float32) for k, v in _attn_params(K, K=K).items()}
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((2, Sq, 64)).astype(np.float32)
    src = rng.standard_normal((2, 11, 64)).astype(np.float32)
    kw = dict(n_heads=8, n_kv_heads=K, head_dim=8, rope_theta=1e4,
              causal=False)
    want, new = jax_layers.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        kv_source=jnp.asarray(src), **kw)
    assert new is None
    got = layers.attention({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x), kv_source=torch.as_tensor(src),
                           **kw)
    assert _rel(got, want) <= REL["float32"]


@pytest.mark.parametrize("Sq", [1, 6])
@pytest.mark.parametrize("K", [2, 8])
def test_attention_reads_precomputed_kv_as_jax(K, Sq):
    """A cache with ``cache_pos=None``: its keys and values are read as
    they are (no rotary, no k-norm) and nothing is written."""
    p = {k: v.astype(np.float32) for k, v in _attn_params(K, K=K).items()}
    rng = np.random.default_rng(10 + Sq)
    x = rng.standard_normal((2, Sq, 64)).astype(np.float32)
    ck = rng.standard_normal((2, 13, K * 8)).astype(np.float32)
    cv = rng.standard_normal((2, 13, K * 8)).astype(np.float32)
    kw = dict(n_heads=8, n_kv_heads=K, head_dim=8, rope_theta=1e4,
              causal=False)
    want, new = jax_layers.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        cache=jax_layers.KVCache(jnp.asarray(ck), jnp.asarray(cv)), **kw)
    cache = layers.KVCache(torch.as_tensor(ck), torch.as_tensor(cv))
    got = layers.attention({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x), cache=cache, **kw)
    assert _rel(got, want) <= REL["float32"]
    assert np.array_equal(cache.k.numpy(), ck) and np.array_equal(
        cache.v.numpy(), cv)


@pytest.mark.parametrize("n_layers", [4, 5])
def test_forward_with_gates_matches_jax(n_layers):
    """4 layers every 2 (2 cross blocks) and 5 every 2 (3, the last group
    one layer)."""
    jcfg, jmodel, params, cfg, model = _models(n_layers)
    assert model.n_cross == -(-n_layers // 2)
    assert [model._group(s) for s in range(model.n_cross)] == \
        [(0, 2), (2, 4), (4, 5)][:model.n_cross]
    toks, img = _tokens(cfg, (2, 10), 1), _image(cfg, 2)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks),
                                      "image_embeds": jnp.asarray(img)})
    with torch.inference_mode():
        got, aux = model({"tokens": toks, "image_embeds": img})
    assert float(aux) == 0.0 and got.shape == (2, 10, cfg.vocab_padded)
    assert _rel(got, want) <= REL["float32"]
    # the gates matter: closed, the logits move
    shut = dict(params, cross=dict(params["cross"], gate=jnp.zeros(
        model.n_cross)))
    closed, _ = jmodel.forward(shut, {"tokens": jnp.asarray(toks),
                                      "image_embeds": jnp.asarray(img)})
    assert _rel(got, closed) > 1e-3


def test_flash_route_matches_jax_pallas_interpret():
    jcfg, _, params, cfg, model = _models(5, "float32", "pallas")
    toks, img = _tokens(cfg, (2, 16), 3), _image(cfg, 2)
    want, _ = jax_build(jcfg.replace(attention_impl="pallas_interpret")) \
        .forward(params, {"tokens": jnp.asarray(toks),
                          "image_embeds": jnp.asarray(img)})
    with torch.inference_mode():
        got, _ = model({"tokens": toks, "image_embeds": img})
    assert _rel(got, want) <= REL["float32"]


def test_forward_runs_k5_per_self_attention_and_k7_per_norm(monkeypatch):
    """K5 once per self-attention layer (never for a cross block), K7 twice
    per layer, once per cross block and once for the final norm."""
    *_, cfg, model = _models(5, "float32", "pallas")
    calls = {"flash_attention": 0, "rmsnorm": 0}

    def count(name):
        fn = getattr(dispatch, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(dispatch, name, count(name))
    with torch.inference_mode():
        model({"tokens": np.zeros((1, 9), np.int64),
               "image_embeds": _image(cfg, 1)})
    assert calls == {"flash_attention": 5, "rmsnorm": 2 * 5 + 3 + 1}


@pytest.mark.parametrize("n_layers", [4, 5])
def test_prefill_and_teacher_forced_decode_match_jax(n_layers):
    jcfg, jmodel, params, cfg, model = _models(n_layers)
    B, S, steps = 2, 12, 6
    prompt, forced = _tokens(cfg, (B, S), 1), _tokens(cfg, (B, steps), 2)
    img = _image(cfg, B)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt),
                                     "image_embeds": jnp.asarray(img)},
                            jmodel.init_cache(B, S + steps))
    with torch.inference_mode():
        cache = model.init_cache(B, S + steps)
        tl, tc = model.prefill({"tokens": prompt, "image_embeds": img},
                               cache)
    assert tc is cache and isinstance(tc, VLMCache)
    assert _rel(tl, jl) <= REL["float32"]

    def leaves(c):
        return {"self_k": c.self_attn.k, "self_v": c.self_attn.v,
                "cross_k": c.cross.k, "cross_v": c.cross.v}

    for name, leaf in leaves(tc).items():
        want = np.asarray(leaves(jc)[name], np.float32)
        assert tuple(leaf.shape) == want.shape, name
        assert _rel(leaf, want) <= REL["float32"], name
    cross = tc.cross.k.clone(), tc.cross.v.clone()
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jl, jc = jmodel.decode_step(params, jc, jnp.int32(S + i),
                                    jnp.asarray(tok))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, S + i, torch.as_tensor(tok))
        assert _rel(tl, jl) <= REL["float32"], i
    for name, leaf in leaves(tc).items():
        assert _rel(leaf, np.asarray(leaves(jc)[name], np.float32)) \
            <= REL["float32"], name
    assert torch.equal(tc.cross.k, cross[0]) and torch.equal(tc.cross.v,
                                                             cross[1])


def test_bf16_forward_at_full_smoke_depth_within_jax_own_error():
    """bfloat16 activations over the whole ragged smoke model (5 layers, 3
    cross blocks): each side rounds at its own points, and the gap grows
    with depth as the reference's own bf16 error (against its float32
    forward) does — 1.54e-2 against 2.06e-2 — so it is held within that
    error; the first group is held at 1e-2 below."""
    jcfg, jmodel, params, cfg, model = _models(5, "bfloat16")
    batch = {"tokens": _tokens(cfg, (2, 10), 4), "image_embeds": _image(cfg,
                                                                        2)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = jmodel.forward(params, jbatch)
    f32, _ = _models(5)[1].forward(params, jbatch)
    with torch.inference_mode():
        got, _ = model(batch)
    assert _rel(got, want) <= max(REL["bfloat16"], _rel(want, f32))


def test_bf16_activations_and_the_promoted_cross_kv():
    """bfloat16 activations over float32 parameters, over the first group
    (a cross block and 2 layers): the forward, the prefill with its cached
    image keys and values (bf16 embeddings times float32 weights in
    float32, then cast) and the decode steps that read them, against JAX;
    the cached keys differ from the prefill's own bf16 projection, as in
    the reference."""
    jcfg, jmodel, params, cfg, model = _models(2, "bfloat16")
    B, S, steps = 2, 10, 4
    prompt, forced = _tokens(cfg, (B, S), 4), _tokens(cfg, (B, steps), 5)
    img = _image(cfg, B)
    batch = {"tokens": prompt, "image_embeds": img}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = jmodel.forward(params, jbatch)
    with torch.inference_mode():
        got, _ = model(batch)
    assert _rel(got, want) <= REL["bfloat16"]
    jl, jc = jmodel.prefill(params, jbatch, jmodel.init_cache(B, S + steps))
    with torch.inference_mode():
        tl, tc = model.prefill(batch, model.init_cache(B, S + steps))
    assert tc.cross.k.dtype == torch.bfloat16
    assert _rel(tl, jl) <= REL["bfloat16"]
    for name in ("k", "v"):
        assert _rel(getattr(tc.cross, name).float(), np.asarray(
            getattr(jc.cross, name), np.float32)) <= REL["bfloat16"], name
    img_bf = torch.as_tensor(img).to(torch.bfloat16)
    own = layers.dense(model.cross[0].attn["wk"], img_bf)
    assert not torch.equal(own, tc.cross.k[0])
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jl, jc = jmodel.decode_step(params, jc, jnp.int32(S + i),
                                    jnp.asarray(tok))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, S + i, torch.as_tensor(tok))
        assert _rel(tl, jl) <= REL["bfloat16"], i


def test_decode_continues_from_the_jax_prefill():
    jcfg, jmodel, params, cfg, model = _models(5)
    prompt, img = _tokens(cfg, (3, 9), 4), _image(cfg, 3)
    _, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt),
                                    "image_embeds": jnp.asarray(img)},
                           jmodel.init_cache(3, 12))
    cache = convert.cache_from_arrays(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    assert isinstance(cache, VLMCache)
    assert cache.cross.k.shape == (3, 3, cfg.n_image_tokens,
                                   cfg.n_kv_heads * cfg.hd)
    tok = _tokens(cfg, (3, 1), 5)
    jl, _ = jmodel.decode_step(params, jc, jnp.int32(9), jnp.asarray(tok))
    with torch.inference_mode():
        tl, _ = model.decode_step(cache, 9, torch.as_tensor(tok))
    assert _rel(tl, jl) <= REL["float32"]


def test_serve_wave_with_image_embeds_equals_jax():
    jcfg, jmodel, params, cfg, model = _models(5)
    prompts, img = _tokens(cfg, (4, 16), 6), _image(cfg, 4)
    want, _ = jax_serve.serve_wave(jmodel, jcfg, params, prompts, 8,
                                   {"image_embeds": jnp.asarray(img)})
    got, stats = serve.serve_wave(model, cfg, prompts, 8,
                                  {"image_embeds": img})
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.tokens_out, stats.requests) == (32, 4)


def test_main_serves_the_vlm_with_seeded_images(capsys):
    s = serve.main(["--arch", "llama-3.2-vision-11b", "--smoke",
                    "--requests", "2", "--batch", "2", "--prompt-len", "6",
                    "--gen", "3", "--device", "cpu"])
    assert (s["requests"], s["tokens_out"]) == (2, 6)
    assert "decode_tok_per_s" in capsys.readouterr().out


def test_init_config_and_converter():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.cross_attn_every, cfg.n_image_tokens, cfg.vocab_padded) == \
        (40, 4096, 32, 8, 128, 5, 1601, 128256)
    smoke = get_smoke_config(ARCH)
    model = build_model(smoke, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert isinstance(model, VisionLM) and model.n_cross == 2
    assert all(float(cb.gate) == 0.0 for cb in model.cross)
    with pytest.raises(ValueError, match="cross_attn_every"):
        build_model(smoke.replace(cross_attn_every=0), device="cpu")
    jcfg, _, params, pcfg, ported = _models(5)
    tree = jax.tree.map(np.asarray, params)
    assert [float(cb.gate) for cb in ported.cross] == pytest.approx(GATES)
    wv = np.array(tree["cross"]["attn"]["wv"][2])
    assert torch.equal(ported.cross[2].attn["wv"], torch.from_numpy(wv))
    with pytest.raises(ValueError, match="not a VisionLM tree"):
        convert.vision_lm_from_arrays(pcfg, dict(tree, extra=1),
                                      device="cpu")
    cross = dict(tree["cross"], gate=tree["cross"]["gate"][:2])
    with pytest.raises(ValueError, match="layers"):
        convert.vision_lm_from_arrays(pcfg, dict(tree, cross=cross),
                                      device="cpu")
    cross = {k: v for k, v in tree["cross"].items() if k != "gate"}
    with pytest.raises(ValueError, match="leaves"):
        convert.vision_lm_from_arrays(pcfg, dict(tree, cross=cross),
                                      device="cpu")


# ------------------------------------------------ chip_smoke rehearsals ---

def _chip_smoke(monkeypatch):
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))

    def counted_attn(q, k, v, causal=True):
        fa.launches["flash_attention"] += 1
        return ref.flash_attention_plain(q, k, v, causal=causal)

    def counted_rms(x, w, eps=1e-6):
        assert x.is_contiguous()
        rk.launches["rmsnorm"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    for mod in (fa, rk):
        monkeypatch.setattr(mod, "launches", dict.fromkeys(mod.launches, 0))
    plan = dispatch._plan
    monkeypatch.setattr(dispatch, "_plan", lambda kind, what, t: "cuda"
                        if kind in ("flash_attention", "rmsnorm")
                        else plan(kind, what, t))
    monkeypatch.setattr(fa, "flash_attention", counted_attn)
    monkeypatch.setattr(rk, "rmsnorm", counted_rms)
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return chip_smoke


def test_chip_smoke_expected_launches_learn_the_vlm():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    full = get_config(ARCH)
    assert chip_smoke.expected_launches(
        full.replace(attention_impl="pallas")) == {
        "flash_attention": 40, "rmsnorm": 80 + 8 + 1}
    for mode in ("prefill", "decode"):
        assert chip_smoke.expected_launches(full, mode) == {
            "flash_attention": 0, "rmsnorm": 89}


def test_chip_smoke_lm_serve_vlm_phase_rehearses_on_the_cpu(monkeypatch,
                                                            capsys):
    """chip_smoke.py's lm_serve phase with the smoke VLM (ragged groups,
    bf16 activations): seeded image embeddings, opened gates, K7 per
    prefill and decode step, no K5, the cross keys and values unchanged
    across decode steps, the plain-route checks."""
    cs = _chip_smoke(monkeypatch)
    for name, value in (("SERVE_BATCH", 2), ("SERVE_PROMPT", 12),
                        ("SERVE_GEN", 5), ("SERVE_FORCED", 3)):
        monkeypatch.setattr(cs, name, value)
    assert ARCH in dict(cs.SERVE_ARCHS)
    cfg = get_smoke_config(ARCH).replace(n_layers=5, act_dtype="bfloat16")
    out = cs.lm_serve_phase(torch, np, torch.device("cpu"), cfg, " (smoke)",
                            profile=False)
    per = cs.expected_launches(cfg, "decode")
    assert per["rmsnorm"] == 2 * 5 + 3 + 1
    assert out["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                               "rmsnorm": per["rmsnorm"] * 5}
    assert out["rel"] == 0.0 and out["cross_unchanged"]
    assert all(not r <= cs.LM_REF_REL for r in out["planted"].values())
    assert f"lm_serve {cfg.name} (smoke)" in capsys.readouterr().out


def test_chip_smoke_lm_forward_vlm_phase_rehearses_on_the_cpu(monkeypatch,
                                                              capsys):
    cs = _chip_smoke(monkeypatch)
    cfg = get_smoke_config(ARCH).replace(n_layers=5, act_dtype="bfloat16",
                                         attention_impl="pallas")
    out = cs.lm_forward_phase(torch, np, torch.device("cpu"), cfg, batch=2,
                              seq=16, timed=False)
    assert out["launches"] == {"flash_attention": 5, "rmsnorm": 14}
    assert out["ref_rel"] <= cs.LM_REF_REL
    assert {k[0] for k in out["held"]} == {"flash_attention", "rmsnorm"}
    assert "lm_forward" in capsys.readouterr().out


def test_count_params_keeps_the_references_floor_of_cross_blocks():
    """The reference's ``count_params`` charges ⌊L / every⌋ cross blocks
    while its ``VisionLM`` builds ⌈L / every⌉; the port copies both (for
    Llama-3.2-Vision, 40 / 5, they agree). From 4 to 5 layers every 2 the
    model gains a layer and a third cross block, the count only the
    layer."""
    from repro.models.api import count_params as jax_count
    from repro_torch.models import count_params
    jcfg, _, _, cfg, model = _models(5)
    four = cfg.replace(n_layers=4)
    assert count_params(cfg) == jax_count(jcfg)
    assert (model.n_cross, _models(4)[-1].n_cross) == (3, 2)
    d, hd = cfg.d_model, cfg.hd
    layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + 2 * d + 3 * d * cfg.d_ff)
    assert count_params(cfg)[0] - count_params(four)[0] == layer
