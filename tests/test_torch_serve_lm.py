"""The port's LM token server (ROADMAP A13a) against the JAX package on
the CPU: the KV and SSM caches, prefill, decode and ``serve_wave`` for the
smoke configs of every dense and SSM arch the port registers, with the
JAX model's parameters carried across (``convert``).

Bars, all float32: prefill logits, every cache leaf and each decode step's
logits ≤1e-5 relative (max |err| / max |want|) to JAX's; ``serve_wave``'s
greedy tokens identical; K6's plain final state ≤1e-5 relative to
``ssd_chunked``'s, with y bitwise the same as without it.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.mamba2 import ssd_chunked  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.mamba2 import SSMCache  # noqa: E402

ARCHS = ["olmo_1b", "granite_8b", "deepseek_coder_33b", "qwen3_32b",
         "mamba2_1_3b"]
NEW = ["granite_8b", "deepseek_coder_33b", "qwen3_32b"]
REL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _leaves(cache):
    if hasattr(cache, "k"):
        return {"k": cache.k, "v": cache.v}
    return {"state": cache.state, "conv": cache.conv}


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """The JAX smoke model, its parameters, and the port's model holding
    the same parameters on the CPU."""
    jcfg = jax_smoke(arch)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    make = (convert.mamba2_lm_from_arrays if cfg.family == "ssm"
            else convert.decoder_lm_from_arrays)
    return jcfg, jmodel, params, cfg, make(cfg, tree, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    jcfg, jmodel, params, cfg, model = _models(arch)
    B, S, steps = 2, 12, 8
    prompt = _tokens(cfg, (B, S), 1)
    forced = _tokens(cfg, (B, steps), 2)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                            jmodel.init_cache(B, S + steps))
    with torch.inference_mode():
        cache = model.init_cache(B, S + steps)
        tl, tc = model.prefill({"tokens": prompt}, cache)
    assert tc is cache and tl.shape == (B, 1, cfg.vocab_padded)
    assert _rel(tl, jl) <= REL
    for name, leaf in _leaves(tc).items():
        want = np.asarray(_leaves(jc)[name], np.float32)
        assert tuple(leaf.shape) == want.shape, name
        assert _rel(leaf, want) <= REL, name
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jl, jc = jmodel.decode_step(params, jc, jnp.int32(S + i),
                                    jnp.asarray(tok))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, S + i, torch.as_tensor(tok))
        assert _rel(tl, jl) <= REL, i
    for name, leaf in _leaves(tc).items():
        assert _rel(leaf, np.asarray(_leaves(jc)[name], np.float32)) <= REL


@pytest.mark.parametrize("arch", ["qwen3_32b", "mamba2_1_3b"])
def test_decode_continues_from_the_jax_prefill(arch):
    """``convert.cache_from_arrays`` carries JAX's prefilled cache across;
    the port's decode from it matches JAX's decode."""
    jcfg, jmodel, params, cfg, model = _models(arch)
    prompt = _tokens(cfg, (3, 9), 4)
    _, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                           jmodel.init_cache(3, 12))
    cache = convert.cache_from_arrays(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    tok = _tokens(cfg, (3, 1), 5)
    jl, _ = jmodel.decode_step(params, jc, jnp.int32(9), jnp.asarray(tok))
    with torch.inference_mode():
        tl, _ = model.decode_step(cache, 9, torch.as_tensor(tok))
    assert _rel(tl, jl) <= REL
    with pytest.raises(TypeError, match="KVCache or SSMCache"):
        convert.cache_from_arrays(object(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_wave_tokens_equal_jax(arch):
    jcfg, jmodel, params, cfg, model = _models(arch)
    prompts = _tokens(cfg, (4, 16), 6)
    want, jstats = jax_serve.serve_wave(jmodel, jcfg, params, prompts, 8)
    got, stats = serve.serve_wave(model, cfg, prompts, 8)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.tokens_out, stats.requests) == (32, 4)
    assert stats.summary().keys() == jstats.summary().keys()


def test_serve_stream_example_job():
    """examples/serve_stream.py's job: qwen3's smoke config, 4 waves of 8
    prompts of 32 tokens, 24 generated; the same tokens as JAX's."""
    jcfg, jmodel, params, cfg, model = _models("qwen3_32b")
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    js, ts = jax_serve.ServeStats(), serve.ServeStats()
    for _ in range(4):
        pj = rng_j.integers(0, jcfg.vocab, (8, 32), dtype=np.int32)
        pt = rng_t.integers(0, cfg.vocab, (8, 32), dtype=np.int32)
        want, js = jax_serve.serve_wave(jmodel, jcfg, params, pj, 24,
                                        stats=js)
        got, ts = serve.serve_wave(model, cfg, pt, 24, stats=ts)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert ts.tokens_out == js.tokens_out == 4 * 8 * 24


@pytest.mark.parametrize("L,chunk", [(16, 8), (20, 8), (5, 8), (8, 8),
                                     (37, 16)])
def test_ssd_final_state_matches_ssd_chunked(L, chunk):
    """K6's plain version returns ``ssd_chunked``'s second output, ragged L
    and a single short chunk included; y is bitwise the y it returns
    without the state."""
    rng = np.random.default_rng(L)
    b, H, P, N = 2, 3, 8, 6
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    B = rng.standard_normal((b, L, N)).astype(np.float32)
    C = rng.standard_normal((b, L, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, L, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    jy, jS = ssd_chunked(*(jnp.asarray(a) for a in (x, B, C, dt, A, D)),
                         chunk)
    args = [torch.from_numpy(a) for a in (x, B, C, dt, A, D)]
    y, S = ref.ssd_scan_plain(*args, chunk, final_state=True)
    assert S.dtype == torch.float32 and S.shape == (b, H, N, P)
    assert _rel(S, jS) <= REL and _rel(y, jy) <= REL
    assert torch.equal(y, ref.ssd_scan_plain(*args, chunk))
    y0, S0 = ref.ssd_scan_plain(*(a[:, :0] for a in args[:4]), A=args[4],
                                D=args[5], chunk=chunk, final_state=True)
    assert y0.shape == (b, 0, H, P) and not S0.any()
    # into a given buffer (the cache's), through the dispatch's CPU route
    buf = torch.full((b, H, N, P), float("nan"))
    y1, S1 = dispatch.ssd_scan(*args, chunk, state_out=buf)
    assert S1 is buf and torch.equal(S1, S) and torch.equal(y1, y)


def test_mamba2_serving_updates_its_cache_in_place():
    """Prefill and decode write each layer's state and conv history into
    the cache's own tensors and return that cache."""
    cfg = get_smoke_config("mamba2_1_3b")
    model = build_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 12)
    state, conv = cache.state, cache.conv
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 9)))
    with torch.inference_mode():
        _, out = model.prefill({"tokens": toks[:, :8]}, cache)
        assert out is cache and out.state is state and out.conv is conv
        after_prefill = state.clone()
        assert after_prefill.abs().sum(dim=(1, 2, 3, 4)).all()
        _, out = model.decode_step(cache, 8, toks[:, 8:])
    assert out.state is state and not torch.equal(state, after_prefill)


def test_registered_configs_equal_jax():
    for arch in NEW:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))
    g = get_config("granite-8b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.hd,
            g.vocab) == (36, 4096, 32, 8, 128, 49152)
    q = get_config("qwen3-32b")
    assert (q.d_model, q.n_heads, q.n_kv_heads, q.hd, q.qk_norm,
            q.vocab) == (5120, 64, 8, 128, True, 151936)


def test_cross_attention_and_extras_wait_for_a13b():
    """With A13b, cross-attention runs: ``kv_source`` and a cache read
    without ``cache_pos`` (holding the source's projected keys and
    values) give the same output and leave the cache as it was; and
    ``serve_wave`` passes ``extras`` into the prefill's batch, which a
    text model ignores, as the reference's does."""
    *_, cfg, model = _models("granite_8b")
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal((2, 3, cfg.d_model)),
                        dtype=torch.float32)
    src = torch.as_tensor(rng.standard_normal((2, 5, cfg.d_model)),
                          dtype=torch.float32)
    blk = model.blocks[0]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, rope_theta=cfg.rope_theta, causal=False)
    with torch.inference_mode():
        got = layers.attention(blk.attn, x, kv_source=src, **kw)
        cache = layers.KVCache(layers.dense(blk.attn["wk"], src),
                               layers.dense(blk.attn["wv"], src))
        held = cache.k.clone(), cache.v.clone()
        read = layers.attention(blk.attn, x, cache=cache, **kw)
    assert got.shape == x.shape and torch.allclose(got, read, atol=1e-6)
    assert torch.equal(cache.k, held[0]) and torch.equal(cache.v, held[1])
    prompts = _tokens(cfg, (2, 6), 22)
    plain, _ = serve.serve_wave(model, cfg, prompts, 3)
    extra, _ = serve.serve_wave(model, cfg, prompts, 3,
                                extras={"image_embeds": np.zeros(1)})
    np.testing.assert_array_equal(plain, extra)


def test_grouped_decode_never_repeats_the_cache(monkeypatch):
    """A one-token decode with G > 1 takes the grouped einsum: no
    ``repeat_interleave`` of the cache."""
    *_, cfg, model = _models("deepseek_coder_33b")
    assert cfg.n_heads // cfg.n_kv_heads > 1
    with torch.inference_mode():
        cache = model.init_cache(2, 6)
        model.prefill({"tokens": _tokens(cfg, (2, 5), 7)}, cache)
        monkeypatch.setattr(torch.Tensor, "repeat_interleave",
                            lambda *a, **k: pytest.fail("cache repeated"))
        logits, _ = model.decode_step(cache, 5, torch.zeros((2, 1),
                                                            dtype=torch.int32))
    assert torch.isfinite(logits).all()


def test_main_serves_a_smoke_model_on_the_cpu(capsys):
    s = serve.main(["--arch", "granite-8b", "--smoke", "--requests", "3",
                    "--batch", "2", "--prompt-len", "6", "--gen", "3",
                    "--device", "cpu"])
    assert (s["requests"], s["tokens_out"]) == (4, 12)
    assert s["F_quality_adjusted"] == pytest.approx(
        s["latency_per_token_s"] / 1.5, abs=1e-6)
    assert "decode_tok_per_s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite_8b", "deepseek_coder_33b"])
def test_smoke_forward_with_the_flash_route_at_head_dim_8(arch):
    """The granite and deepseek smoke configs have head dim 8 (d 64, 8
    heads), which K5 now builds (ROADMAP C4): the port's forward with
    ``attention_impl="pallas"`` matches JAX's Pallas route in interpret
    mode, and the wrapper's shape check takes the shape."""
    jcfg, jmodel, params, cfg, _ = _models(arch)
    assert cfg.hd == 8
    fa.check_shape(2, 16, cfg.n_heads, cfg.hd)
    toks = _tokens(cfg, (2, 16), 8)
    want, _ = jax_build(jcfg.replace(attention_impl="pallas_interpret")) \
        .forward(params, {"tokens": jnp.asarray(toks)})
    model = convert.decoder_lm_from_arrays(
        cfg.replace(attention_impl="pallas"),
        jax.tree.map(np.asarray, params), device="cpu")
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert _rel(got, want) <= REL


def test_ssm_cache_is_reference_shaped():
    *_, cfg, model = _models("mamba2_1_3b")
    cache = model.init_cache(3, 100)
    assert isinstance(cache, SSMCache)
    assert cache.state.shape == (cfg.n_layers, 3, cfg.ssm_heads,
                                 cfg.ssm_state, cfg.ssm_head_dim)
    assert cache.conv.shape == (cfg.n_layers, 3, cfg.ssm_conv - 1,
                                cfg.d_inner + 2 * cfg.ssm_state)
    assert cache.state.dtype == torch.float32
    assert cache.conv.dtype == cfg.adtype


def _chip_smoke(monkeypatch):
    """chip_smoke imported from the repository root, with K6 and K7 routed
    to counted plain versions on the CPU, the card's memory counters
    stubbed, and the launch counts restored after the test."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))

    def counted_ssd(*args, **kw):
        sk.launches["ssd_scan"] += 1
        return ref.ssd_scan_plain(*args, **kw)

    def counted_rms(x, w, eps=1e-6):
        assert x.is_contiguous()        # the wrapper refuses other rows
        rk.launches["rmsnorm"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    for mod in (fa, sk, rk):
        monkeypatch.setattr(mod, "launches", dict.fromkeys(mod.launches, 0))
    plan = dispatch._plan
    monkeypatch.setattr(dispatch, "_plan", lambda kind, what, t: "cuda"
                        if kind in ("ssd_scan", "rmsnorm")
                        else plan(kind, what, t))
    monkeypatch.setattr(sk, "ssd_scan", counted_ssd)
    monkeypatch.setattr(rk, "rmsnorm", counted_rms)
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return chip_smoke


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_lm_serve_phase_rehearses_on_the_cpu(monkeypatch, capsys,
                                                        arch):
    """chip_smoke.py's lm_serve phase at a smoke config on the CPU: the
    launch counts the model implies (K7 per prefill and per decode step,
    K6 per Mamba2 prefill), the kernels held on the operands the model
    hands them, the plain-route checks at the cut and full depth, the
    planted faults failing both, and every swap undone after it."""
    from repro_torch.kernels import rmsnorm as rk
    cs = _chip_smoke(monkeypatch)
    for name, value in (("SERVE_BATCH", 2), ("SERVE_PROMPT", 12),
                        ("SERVE_GEN", 5), ("SERVE_FORCED", 3)):
        monkeypatch.setattr(cs, name, value)
    counted = rk.rmsnorm
    cfg = get_smoke_config(arch)
    out = cs.lm_serve_phase(torch, np, torch.device("cpu"), cfg, " (smoke)",
                            profile=False)
    per = cs.expected_launches(cfg)
    assert out["launches"]["rmsnorm"] == per["rmsnorm"] * 5
    assert out["launches"]["ssd_scan"] == per.get("ssd_scan", 0)
    assert out["rel"] == 0.0 and out["rel_cut"] == 0.0
    assert rk.rmsnorm is counted
    kinds = {h.split()[1] for h in out["held"]}
    assert kinds == ({"rmsnorm"} if cfg.norm_type == "rmsnorm" else set()) \
        | ({"ssd_scan"} if cfg.family == "ssm" else set())
    assert set(out["planted"]) == set(out["planted_cut"]) == set(
        cs.wrong_ssm_kernels(torch, cfg))
    assert all(not r <= cs.LM_REF_REL for r in out["planted"].values())
    assert f"lm_serve {cfg.name} (smoke)" in capsys.readouterr().out


def test_chip_smoke_kernel_limit_phases_rehearse_on_the_cpu(monkeypatch,
                                                            capsys):
    """chip_smoke.py's K5-limits and K6-final-state phases at small shapes
    on the CPU, with the kernels swapped for their plain versions behind
    the wrappers' shape checks."""
    cs = _chip_smoke(monkeypatch)

    def plain_fa(q, k, v, causal=True):
        fa.check_shape(*q.shape)
        return ref.flash_attention_plain(q, k, v, causal)

    monkeypatch.setattr(fa, "flash_attention", plain_fa)
    monkeypatch.setattr(cs, "ATTN_WIDE", (64, 8, 4, 16))
    monkeypatch.setattr(cs, "SSD_CASES", cs.SSD_CASES[:4])
    monkeypatch.setattr(cs, "SSD_SLOW_CASES", [(1, 40, 2, 8, 16, 16)])
    monkeypatch.setattr(cs, "SSM_CHUNK", 16)
    cpu = torch.device("cpu")
    worst = cs.attention_limits_phase(torch, cpu)
    assert len(worst) == 4 and max(worst.values()) <= cs.REL
    worst = cs.ssd_final_state_phase(torch, cpu, [(2, 40, 4, 8, 16)])
    assert set(worst) == {"float32", "bfloat16"}
    text = capsys.readouterr().out
    assert "ROADMAP C4" in text and "y bitwise equal" in text


def test_cache_from_arrays_carries_bfloat16_leaves_exactly():
    """A bf16 reference cache (the full configs' activation dtype) crosses
    over through float32, bit for bit."""
    from repro.models.layers import KVCache as JaxKVCache
    from repro.models.mamba2 import SSMCache as JaxSSMCache
    rng = np.random.default_rng(9)
    k, v, conv = (jnp.asarray(rng.standard_normal((2, 1, 5, 8)),
                              jnp.bfloat16) for _ in range(3))
    state = jnp.asarray(rng.standard_normal((2, 1, 3, 4, 8)), jnp.float32)
    kv = convert.cache_from_arrays(JaxKVCache(k, v), device="cpu")
    ssm = convert.cache_from_arrays(JaxSSMCache(state, conv), device="cpu")
    assert kv.k.dtype == ssm.conv.dtype == torch.bfloat16
    assert ssm.state.dtype == torch.float32
    np.testing.assert_array_equal(kv.v.float().numpy(),
                                  np.asarray(v, np.float32))
    np.testing.assert_array_equal(ssm.conv.float().numpy(),
                                  np.asarray(conv, np.float32))
    np.testing.assert_array_equal(ssm.state.numpy(), np.asarray(state))
