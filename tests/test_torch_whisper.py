"""The port's Whisper-large-v3-style encoder–decoder against the JAX
package on the CPU: the encoder (non-causal, with rotary, tanh GELU), the
smoke forward (both attention routes for the decoder's self-attention),
prefill — the encoder's keys and values computed once in float32 from the
bf16 encoder output and read back by the prefill's own decoder pass — and
teacher-forced decode with every cache leaf, bfloat16 activations over
float32 parameters, ``serve_wave`` with ``audio_frames``, a decode from
the reference's prefill, the converter, and the rehearsals of
``chip_smoke.py``'s Whisper phases.

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
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.whisper import EncDecCache, EncDecLM  # noqa: E402

ARCH = "whisper_large_v3"
REL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


@functools.lru_cache(maxsize=None)
def _models(act: str = "float32", impl: str = "reference"):
    """The JAX smoke model with ``act`` activations, its parameters, and
    the port's model holding them on the CPU."""
    jcfg = jax_smoke(ARCH).replace(act_dtype=act)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg)).replace(
        attention_impl=impl)
    model = convert.enc_dec_lm_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jmodel, params, cfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _frames(cfg, B, seed=8):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def test_encoder_matches_jax():
    jcfg, jmodel, params, cfg, model = _models()
    frames = _frames(cfg, 3)
    want = jmodel.encode(params, jnp.asarray(frames))
    with torch.inference_mode():
        got = model.encode(frames)
    assert got.shape == (3, cfg.n_audio_frames, cfg.d_model)
    assert _rel(got, want) <= REL["float32"]


@pytest.mark.parametrize("S", [7, 16])
def test_forward_matches_jax(S):
    jcfg, jmodel, params, cfg, model = _models()
    toks, frames = _tokens(cfg, (2, S), S), _frames(cfg, 2)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks),
                                      "audio_frames": jnp.asarray(frames)})
    with torch.inference_mode():
        got, aux = model({"tokens": toks, "audio_frames": frames})
    assert float(aux) == 0.0 and got.shape == (2, S, cfg.vocab_padded)
    assert _rel(got, want) <= REL["float32"]


def test_flash_route_matches_jax_pallas_interpret():
    jcfg, _, params, cfg, model = _models("float32", "pallas")
    toks, frames = _tokens(cfg, (2, 16), 3), _frames(cfg, 2)
    want, _ = jax_build(jcfg.replace(attention_impl="pallas_interpret")) \
        .forward(params, {"tokens": jnp.asarray(toks),
                          "audio_frames": jnp.asarray(frames)})
    with torch.inference_mode():
        got, _ = model({"tokens": toks, "audio_frames": frames})
    assert _rel(got, want) <= REL["float32"]


def test_forward_runs_k5_on_the_decoder_and_k7_per_norm(monkeypatch):
    """K5 once per decoder self-attention (the encoder and the
    cross-attention take the chunked reference); K7 for 2 norms per
    encoder layer, ``enc_norm``, 3 per decoder layer and the final norm in
    a forward or a prefill, 3 per layer and the final norm in a decode
    step."""
    *_, cfg, model = _models("float32", "pallas")
    calls = {"flash_attention": 0, "rmsnorm": 0}

    def count(name):
        fn = getattr(dispatch, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(dispatch, name, count(name))
    batch = {"tokens": np.zeros((1, 9), np.int64),
             "audio_frames": _frames(cfg, 1)}
    with torch.inference_mode():
        model(batch)
        assert calls == {"flash_attention": 2, "rmsnorm": 4 + 1 + 6 + 1}
        cache = model.init_cache(1, 10)
        model.prefill(batch, cache)
        assert calls == {"flash_attention": 2, "rmsnorm": 2 * 12}
        model.decode_step(cache, 9, torch.zeros((1, 1), dtype=torch.long))
        assert calls == {"flash_attention": 2, "rmsnorm": 2 * 12 + 7}


def test_prefill_and_teacher_forced_decode_match_jax():
    jcfg, jmodel, params, cfg, model = _models()
    B, S, steps = 2, 12, 6
    prompt, forced = _tokens(cfg, (B, S), 1), _tokens(cfg, (B, steps), 2)
    frames = _frames(cfg, B)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt),
                                     "audio_frames": jnp.asarray(frames)},
                            jmodel.init_cache(B, S + steps))
    with torch.inference_mode():
        cache = model.init_cache(B, S + steps)
        tl, tc = model.prefill({"tokens": prompt, "audio_frames": frames},
                               cache)
    assert tc is cache and isinstance(tc, EncDecCache)
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


def test_bf16_activations_and_the_promoted_cross_kv():
    """bfloat16 activations over float32 parameters: the forward (the
    encoder output projected through ``dense``), the prefill (the
    encoder's keys and values in float32, then cast, read back by its own
    decoder pass) with its cross caches, and each decode step from the
    reference's cache of the step before (carried across with the
    converter: a teacher-forced run from the port's own prefill drifts, at
    4 bf16 layers, as far from JAX's as either lies from its float32 run,
    ≈ 1e-2)."""
    jcfg, jmodel, params, cfg, model = _models("bfloat16")
    B, S, steps = 2, 10, 4
    batch = {"tokens": _tokens(cfg, (B, S), 4),
             "audio_frames": _frames(cfg, B)}
    forced = _tokens(cfg, (B, steps), 5)
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
    for i in range(steps):
        tc = convert.cache_from_arrays(jax.tree.map(np.asarray, jc),
                                       device="cpu")
        tok = forced[:, i:i + 1]
        jl, jc = jmodel.decode_step(params, jc, jnp.int32(S + i),
                                    jnp.asarray(tok))
        with torch.inference_mode():
            tl, _ = model.decode_step(tc, S + i, torch.as_tensor(tok))
        assert _rel(tl, jl) <= REL["bfloat16"], i


def test_decode_continues_from_the_jax_prefill():
    jcfg, jmodel, params, cfg, model = _models()
    prompt, frames = _tokens(cfg, (3, 9), 4), _frames(cfg, 3)
    _, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt),
                                    "audio_frames": jnp.asarray(frames)},
                           jmodel.init_cache(3, 12))
    cache = convert.cache_from_arrays(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    assert isinstance(cache, EncDecCache)
    tok = _tokens(cfg, (3, 1), 5)
    jl, _ = jmodel.decode_step(params, jc, jnp.int32(9), jnp.asarray(tok))
    with torch.inference_mode():
        tl, _ = model.decode_step(cache, 9, torch.as_tensor(tok))
    assert _rel(tl, jl) <= REL["float32"]
    with pytest.raises(TypeError, match="KVCache or SSMCache"):
        convert.cache_from_arrays(object(), device="cpu")


def test_serve_wave_with_audio_frames_equals_jax():
    jcfg, jmodel, params, cfg, model = _models()
    prompts, frames = _tokens(cfg, (4, 16), 6), _frames(cfg, 4)
    want, _ = jax_serve.serve_wave(jmodel, jcfg, params, prompts, 8,
                                   {"audio_frames": jnp.asarray(frames)})
    got, stats = serve.serve_wave(model, cfg, prompts, 8,
                                  {"audio_frames": torch.as_tensor(frames)})
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.tokens_out, stats.requests) == (32, 4)


def test_main_serves_whisper_with_seeded_frames(capsys):
    s = serve.main(["--arch", "whisper-large-v3", "--smoke", "--requests",
                    "2", "--batch", "2", "--prompt-len", "6", "--gen", "3",
                    "--device", "cpu"])
    assert (s["requests"], s["tokens_out"]) == (2, 6)
    assert "decode_tok_per_s" in capsys.readouterr().out


def test_config_init_and_converter():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.hd, cfg.d_ff, cfg.mlp_kind, cfg.n_audio_frames, cfg.vocab,
            cfg.vocab_padded) == (32, 32, 1280, 20, 64, 5120, "gelu", 1500,
                                  51866, 51968)
    smoke = get_smoke_config(ARCH)
    model = build_model(smoke, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert isinstance(model, EncDecLM)
    assert len(model.encoder) == len(model.decoder) == 2
    assert float(model.decoder[1].ln_x.min()) == 1.0
    with pytest.raises(ValueError, match="encoder_layers"):
        build_model(smoke.replace(encoder_layers=0), device="cpu")
    jcfg, _, params, pcfg, ported = _models()
    tree = jax.tree.map(np.asarray, params)
    wk = np.array(tree["decoder"]["cross_attn"]["wk"][1])
    assert torch.equal(ported.decoder[1].cross_attn["wk"],
                       torch.from_numpy(wk))
    with pytest.raises(ValueError, match="not a EncDecLM tree"):
        convert.enc_dec_lm_from_arrays(pcfg, dict(tree, extra=1),
                                       device="cpu")
    dec = dict(tree["decoder"], mlp=dict(tree["decoder"]["mlp"], wg=1))
    with pytest.raises(ValueError, match="layers|no leaf"):
        convert.enc_dec_lm_from_arrays(pcfg, dict(tree, decoder=dec),
                                       device="cpu")
    with pytest.raises(ValueError, match="layers"):
        convert.enc_dec_lm_from_arrays(pcfg.replace(encoder_layers=3), tree,
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


def test_chip_smoke_expected_launches_learn_whisper():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    full = get_config(ARCH)
    assert chip_smoke.expected_launches(
        full.replace(attention_impl="pallas")) == {
        "flash_attention": 32, "rmsnorm": 64 + 1 + 96 + 1}
    assert chip_smoke.expected_launches(full, "prefill") == {
        "flash_attention": 0, "rmsnorm": 162}
    assert chip_smoke.expected_launches(full, "decode") == {
        "flash_attention": 0, "rmsnorm": 97}


def test_chip_smoke_lm_serve_whisper_phase_rehearses_on_the_cpu(monkeypatch,
                                                                capsys):
    cs = _chip_smoke(monkeypatch)
    for name, value in (("SERVE_BATCH", 2), ("SERVE_PROMPT", 12),
                        ("SERVE_GEN", 5), ("SERVE_FORCED", 3)):
        monkeypatch.setattr(cs, name, value)
    assert ARCH in dict(cs.SERVE_ARCHS)
    cfg = get_smoke_config(ARCH).replace(act_dtype="bfloat16")
    out = cs.lm_serve_phase(torch, np, torch.device("cpu"), cfg, " (smoke)",
                            profile=False)
    pre, dec = (cs.expected_launches(cfg, m)["rmsnorm"]
                for m in ("prefill", "decode"))
    assert (pre, dec) == (12, 7)
    assert out["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                               "rmsnorm": pre + 4 * dec}
    assert out["rel"] == 0.0 and out["cross_unchanged"]
    assert all(not r <= cs.LM_REF_REL for r in out["planted"].values())
    assert f"lm_serve {cfg.name} (smoke)" in capsys.readouterr().out


def test_chip_smoke_lm_forward_whisper_phase_rehearses_on_the_cpu(
        monkeypatch, capsys):
    cs = _chip_smoke(monkeypatch)
    cfg = get_smoke_config(ARCH).replace(act_dtype="bfloat16",
                                         attention_impl="pallas")
    out = cs.lm_forward_phase(torch, np, torch.device("cpu"), cfg, batch=2,
                              seq=16, timed=False)
    assert out["launches"] == {"flash_attention": 2, "rmsnorm": 12}
    assert out["ref_rel"] <= cs.LM_REF_REL
    assert {k[0] for k in out["held"]} == {"flash_attention", "rmsnorm"}
    assert "lm_forward" in capsys.readouterr().out
