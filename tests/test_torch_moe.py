"""The port's MoE FFN and MoE decoder (Arctic-480B, Grok-1-314B) against
the JAX package on the CPU: ``moe_ffn``'s output and aux loss (capacity
drops, a padded last group, all-zero rows whose router rows tie, a
decode-sized group with C = 1), the dispatch by index against the
reference's one-hot einsum, the smoke forward (both attention routes),
prefill and teacher-forced decode, ``serve_wave``, ``model_op``, the
converter, the configs and the accounting of all ten architectures, the
count of a forward on tensors without data, and the rehearsals of
``chip_smoke.py``'s MoE phases.

Bars: float32 outputs, aux losses, logits, cache leaves and scores ≤1e-5
relative (max |err| / max |want|) to JAX's; bfloat16 activations over
float32 parameters ≤1e-2; the dispatch bitwise; greedy tokens, configs and
accounting equal.
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

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.api import analytic_flops as jax_flops  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import count_params as jax_count  # noqa: E402
from repro.streaming import operators as jax_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import analytic_flops, build_model  # noqa: E402
from repro_torch.models import count_params, moe  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.perf import counts  # noqa: E402
from repro_torch.streaming import operators as port_ops  # noqa: E402

ARCHS = ["arctic_480b", "grok_1_314b"]
REL = {"float32": 1e-5, "bfloat16": 1e-2}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _port(jcfg, **kw) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg)).replace(**kw)


@functools.lru_cache(maxsize=None)
def _ffn(arch: str):
    """JAX's smoke MoE parameters and the port's MoE holding them."""
    jcfg = jax_smoke(arch)
    params = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    cfg = _port(jcfg)
    p = moe.MoE(cfg, "cpu")
    convert._load_stacked(
        [p], jax.tree.map(lambda a: np.asarray(a)[None], params), "moe")
    return jcfg, params, cfg, p


@functools.lru_cache(maxsize=None)
def _models(arch: str, act: str = "float32", impl: str = "reference"):
    """The JAX smoke model with ``act`` activations, its parameters, and
    the port's model holding the same parameters on the CPU."""
    jcfg = jax_smoke(arch).replace(act_dtype=act)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = _port(jcfg, attention_impl=impl)
    model = convert.decoder_lm_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jmodel, params, cfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _drops(p, cfg, x: torch.Tensor) -> int:
    """(token, choice) pairs of x's real tokens dropped by capacity."""
    B, S, d = x.shape
    g, G, C = moe.capacity(cfg, B * S)
    xz = torch.nn.functional.pad(x.reshape(-1, d), (0, 0, 0, G * g - B * S))
    keep = moe._route(p, xz.reshape(G, g, d), cfg, C)[4]
    return int((~keep.reshape(-1, cfg.moe_top_k)[:B * S]).sum())


# the cases of moe_ffn: (B, S) and whether rows are zeroed
CASES = {
    "one_group": (2, 16, False),      # 32 tokens, g 32: one whole group
    "padded": (2, 21, False),         # 42 tokens: the last group padded 22
    "zero_rows": (4, 16, True),       # rows of zeros: router rows that tie
    "decode": (2, 1, False),          # g 2, C 1
    "skewed": (4, 40, False),         # a shared offset: capacity drops
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, case):
    jcfg, params, cfg, p = _ffn(arch)
    B, S, zero = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if zero:
        x[1, 2:7] = 0.0
        x[3, -1] = 0.0
    if case == "skewed":      # every token leans to the same experts
        x += 2.0 * rng.standard_normal(cfg.d_model).astype(np.float32)
    want, want_aux = jax_moe.moe_ffn(params, jnp.asarray(x), jcfg)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        got, aux = moe.moe_ffn(p, xt, cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) <= REL["float32"]
    assert abs(float(aux) - float(want_aux)) <= REL["float32"] * abs(
        float(want_aux))
    g, G, C = moe.capacity(cfg, B * S)
    assert (g, G, C) == {"one_group": (32, 1, 20), "padded": (32, 2, 20),
                         "zero_rows": (32, 2, 20), "decode": (2, 1, 1),
                         "skewed": (32, 5, 20)}[case]
    if case in ("decode", "skewed"):
        assert _drops(p, cfg, xt) > 0


def test_zero_rows_pick_the_lowest_experts():
    """A row of zeros ties on every expert: like ``lax.top_k``, the
    selection takes experts 0 and 1, in that order, and both gates are
    ½."""
    _, _, cfg, p = _ffn("arctic_480b")
    xg = torch.zeros((1, 32, cfg.d_model))
    xg[0, :5] = torch.randn((5, cfg.d_model))
    probs, gates, idx, pos, keep, _ = moe._route(p, xg, cfg, 20)
    assert idx[0, 5:].tolist() == [[0, 1]] * 27
    assert torch.equal(gates[0, 5:], torch.full((27, 2), 0.5))
    # FIFO over the token-major flattening: the tied rows fill experts 0
    # and 1 in token order until C runs out
    first = (idx[0, :, 0] == 0).nonzero()[:, 0]
    assert pos[0, first, 0].tolist() == sorted(pos[0, first, 0].tolist())
    assert not keep[0, -1].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_by_index_is_the_one_hot_einsum(arch):
    """The experts' inputs gathered by index equal, bitwise, the
    reference's ``einsum("GgEc,Ggd->GEcd", disp, xg)`` with its one-hot
    dispatch tensor, transcribed in torch — at a padded group and with
    capacity drops."""
    _, _, cfg, p = _ffn(arch)
    E, k = cfg.moe_experts, cfg.moe_top_k
    x = torch.randn((3, 17, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) + 1.5
    g, G, C = moe.capacity(cfg, 51)
    xz = torch.nn.functional.pad(x.reshape(-1, cfg.d_model),
                                 (0, 0, 0, G * g - 51)).reshape(G, g, -1)
    _, _, idx, pos, keep, _ = moe._route(p, xz, cfg, C)
    assert not keep.all()
    got = moe._dispatch(xz, idx, pos, keep, E, C)
    sel = torch.nn.functional.one_hot(idx, E).float()
    pos_oh = torch.nn.functional.one_hot(pos.clamp(max=C), C + 1)[
        ..., :C].float() * keep[..., None]
    disp = torch.einsum("GgkE,Ggkc->GgEc", sel, pos_oh)
    want = torch.einsum("GgEc,Ggd->GEcd", disp, xz)
    assert torch.equal(got, want.transpose(0, 1).reshape(E, G * C, -1))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_activations_match_jax(arch):
    jcfg, params, cfg, p = _ffn(arch)
    x = np.random.default_rng(5).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    want, want_aux = jax_moe.moe_ffn(
        params, jnp.asarray(x, jnp.bfloat16), jcfg.replace(
            act_dtype="bfloat16"))
    with torch.no_grad():
        got, aux = moe.moe_ffn(p, torch.as_tensor(x).to(torch.bfloat16),
                               cfg.replace(act_dtype="bfloat16"))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= REL["bfloat16"]
    assert abs(float(aux) - float(want_aux)) <= REL["bfloat16"]


@pytest.mark.parametrize("S", [16, 20])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_jax(arch, S):
    jcfg, jmodel, params, cfg, model = _models(arch)
    toks = _tokens(cfg, (2, S), S)
    want, want_aux = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = model({"tokens": toks})
    assert got.shape == (2, S, cfg.vocab_padded)
    assert _rel(got, want) <= REL["float32"]
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_activations_match_jax(arch):
    """bfloat16 activations over float32 parameters: the first layer at
    the bf16 bar; the whole smoke model (2 layers) within the reference's
    own bf16 error against its float32 forward where that is larger (each
    side rounds at its own points, and the gap grows with depth as that
    error does: 1.41e-2 against 1.56e-2 for Arctic's smoke model)."""
    jcfg, jmodel, params, cfg, model = _models(arch, "bfloat16")
    toks = _tokens(cfg, (2, 16), 9)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    f32, _ = _models(arch)[1].forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert _rel(got, want) <= max(REL["bfloat16"], _rel(want, f32))
    cut = jcfg.replace(n_layers=1)
    tree = jax.tree.map(lambda a: np.asarray(a), params)
    tree["blocks"] = jax.tree.map(lambda a: a[:1], tree["blocks"])
    want, _ = jax_build(cut).forward(jax.tree.map(jnp.asarray, tree),
                                     {"tokens": jnp.asarray(toks)})
    model = convert.decoder_lm_from_arrays(_port(cut), tree, device="cpu")
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert _rel(got, want) <= REL["bfloat16"]


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_matches_jax_pallas_interpret(arch):
    jcfg, _, params, cfg, model = _models(arch, "float32", "pallas")
    fa.check_shape(2, 16, cfg.n_heads, cfg.hd)
    toks = _tokens(cfg, (2, 16), 3)
    want, _ = jax_build(jcfg.replace(attention_impl="pallas_interpret")) \
        .forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert _rel(got, want) <= REL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    """Prefill (one padded group) and 8 decode steps at B 2 (g 2, C 1:
    two tokens' four choices over four experts drop on every clash)."""
    jcfg, jmodel, params, cfg, model = _models(arch)
    B, S, steps = 2, 12, 8
    prompt, forced = _tokens(cfg, (B, S), 1), _tokens(cfg, (B, steps), 2)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                            jmodel.init_cache(B, S + steps))
    with torch.inference_mode():
        cache = model.init_cache(B, S + steps)
        tl, tc = model.prefill({"tokens": prompt}, cache)
    assert tc is cache and _rel(tl, jl) <= REL["float32"]
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jl, jc = jmodel.decode_step(params, jc, jnp.int32(S + i),
                                    jnp.asarray(tok))
        with torch.inference_mode():
            tl, tc = model.decode_step(tc, S + i, torch.as_tensor(tok))
        assert _rel(tl, jl) <= REL["float32"], i
    for name in ("k", "v"):
        assert _rel(getattr(tc, name), np.asarray(getattr(jc, name))) \
            <= REL["float32"], name


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_wave_tokens_equal_jax(arch):
    jcfg, jmodel, params, cfg, model = _models(arch)
    prompts = _tokens(cfg, (4, 16), 6)
    want, _ = jax_serve.serve_wave(jmodel, jcfg, params, prompts, 8)
    got, stats = serve.serve_wave(model, cfg, prompts, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.tokens_out, stats.requests) == (32, 4)


def test_main_serves_arctic_on_the_cpu(capsys):
    s = serve.main(["--arch", "arctic-480b", "--smoke", "--requests", "2",
                    "--batch", "2", "--prompt-len", "6", "--gen", "3",
                    "--device", "cpu"])
    assert (s["requests"], s["tokens_out"]) == (2, 6)
    assert "decode_tok_per_s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_op_drops_the_aux_loss_and_matches_jax(arch):
    jcfg, jmodel, params, cfg, model = _models(arch)
    rows = np.random.default_rng(3).integers(-2, cfg.vocab + 5, (6, 16))
    want = jax_ops.model_op("lm", jmodel, params, jcfg).fn(rows)
    got = port_ops.model_op("lm", model).fn(rows)
    assert got.dtype == np.float32 and got.shape == (6, 1)
    assert _rel(got, want) <= REL["float32"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_and_its_accounting_match_jax(arch):
    for get, jget in ((get_config, jax_config), (get_smoke_config,
                                                 jax_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    for c, jc in ((get_config(arch), jax_config(arch)),
                  (get_smoke_config(arch), jax_smoke(arch))):
        assert count_params(c) == jax_count(jc)
        for mode in ("train", "prefill", "decode"):
            assert analytic_flops(c, 2048, 11, mode) == \
                jax_flops(jc, 2048, 11, mode)


def test_full_widths_and_capacity():
    a, g = get_config("arctic-480b"), get_config("grok-1-314b")
    assert (a.n_layers, a.d_model, a.n_heads, a.n_kv_heads, a.hd, a.d_ff,
            a.moe_experts, a.moe_dense_residual, a.vocab_padded) == \
        (35, 7168, 56, 8, 128, 4864, 128, True, 32000)
    assert (g.n_layers, g.d_model, g.n_heads, g.hd, g.d_ff, g.moe_experts,
            g.vocab_padded) == (64, 6144, 48, 128, 32768, 8, 131072)
    # an 11 x 2048 lm_score shard: 5.5 groups of 4096; decode at B 8
    assert moe.capacity(a, 11 * 2048) == (4096, 6, 80)
    assert moe.capacity(a, 8) == (8, 1, 1)
    assert moe.capacity(g, 8 * 512) == (4096, 1, 1280)


def test_init_scales_and_dtypes():
    """The router stays float32 in a bf16 model; the expert weights are
    drawn in their own dtype at d^-½ (inputs) and f^-½ (outputs): the
    fan-in, not the expert axis."""
    cfg = get_smoke_config("arctic_480b").replace(
        d_model=256, d_ff=1024, param_dtype="bfloat16")
    model = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    p = model.blocks[0].moe
    assert p.router.dtype == torch.float32
    assert {t.dtype for t in (p.wi_gate, p.wi_up, p.wo)} == {torch.bfloat16}
    for t, fan_in in ((p.router, 256), (p.wi_gate, 256), (p.wo, 1024),
                      (p.dense_residual["wo"], 1024)):
        assert abs(float(t.float().std()) * fan_in ** 0.5 - 1) < 0.05


def test_builder_routes_moe_and_ssm_hybrid_ignore_experts():
    smoke = get_smoke_config("arctic_480b")
    model = build_model(smoke, device="cpu")
    assert isinstance(model, DecoderLM) and hasattr(model.blocks[0], "moe")
    dense_with_experts = get_smoke_config("olmo_1b").replace(moe_experts=4)
    assert hasattr(build_model(dense_with_experts, device="cpu").blocks[0],
                   "moe")
    for arch in ("mamba2_1_3b", "zamba2_1_2b"):
        built = build_model(get_smoke_config(arch).replace(moe_experts=4),
                            device="cpu")
        assert not any("moe" in n for n, _ in built.named_parameters())
    with pytest.raises(ValueError, match="families"):
        DecoderLM(get_smoke_config("mamba2_1_3b"), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(smoke.replace(family="gnn"), device="cpu")


def test_converter_carries_and_refuses_moe_trees():
    jcfg, _, params, cfg, model = _models("arctic_480b")
    tree = jax.tree.map(np.asarray, params)
    wo = tree["blocks"]["moe"]["wo"][1]
    assert torch.equal(model.blocks[1].moe.wo, torch.from_numpy(wo.copy()))
    res = tree["blocks"]["moe"]["dense_residual"]["wi_up"][0]
    assert torch.equal(model.blocks[0].moe.dense_residual["wi_up"],
                       torch.from_numpy(res))
    bad = dict(tree, blocks=dict(tree["blocks"], mlp=tree["blocks"]["moe"]))
    with pytest.raises(ValueError, match="not a MoE DecoderLM blocks tree"):
        convert.decoder_lm_from_arrays(cfg, bad, device="cpu")
    moe_tree = dict(tree["blocks"]["moe"])
    del moe_tree["dense_residual"]
    with pytest.raises(ValueError, match="leaves"):
        convert.decoder_lm_from_arrays(
            cfg, dict(tree, blocks=dict(tree["blocks"], moe=moe_tree)),
            device="cpu")
    moe_tree = dict(tree["blocks"]["moe"],
                    router=tree["blocks"]["moe"]["router"][:, :, :2])
    with pytest.raises(ValueError, match="router: shape"):
        convert.decoder_lm_from_arrays(
            cfg, dict(tree, blocks=dict(tree["blocks"], moe=moe_tree)),
            device="cpu")
    with pytest.raises(ValueError, match="not a dense DecoderLM"):
        convert.decoder_lm_from_arrays(cfg.replace(moe_experts=0), tree,
                                       device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_count_without_data_equals_the_count_with_data(arch):
    """The routing's shapes never depend on its values, so the forward
    runs on fake tensors (the perf record's CPU route) and counts the
    FLOPs the real forward counts."""
    *_, cfg, model = _models(arch, "float32", "pallas")
    toks = torch.as_tensor(_tokens(cfg, (2, 20), 4))
    with torch.inference_mode():
        real = counts.analyze_call(model, ({"tokens": toks},))
    with counts.without_data(), torch.inference_mode():
        host = build_model(cfg, device="cpu")
        fake = counts.analyze_call(host, ({"tokens": torch.zeros(
            (2, 20), dtype=torch.int32)},))
    assert fake.flops == real.flops > 0
    assert set(fake.kernels) == set(real.kernels) == {"flash_attention",
                                                      "rmsnorm"}
    assert all(fake.kernels[k]["flops"] == real.kernels[k]["flops"]
               for k in real.kernels)


# ------------------------------------------------ chip_smoke rehearsals ---

def _chip_smoke(monkeypatch):
    """chip_smoke imported from the repository root, K5 and K7 routed to
    counted plain versions on the CPU, the card's memory counters
    stubbed."""
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
        assert x.is_contiguous()        # the wrapper refuses other rows
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


def test_chip_smoke_expected_launches_learn_the_moe_decoder():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    arctic = get_config("arctic_480b").replace(n_layers=2,
                                               attention_impl="pallas")
    assert chip_smoke.expected_launches(arctic) == {
        "flash_attention": 2, "rmsnorm": 5}
    grok = get_config("grok_1_314b").replace(n_layers=4)
    for mode in ("prefill", "decode"):
        assert chip_smoke.expected_launches(grok, mode) == {
            "flash_attention": 0, "rmsnorm": 9}


def test_chip_smoke_lm_score_moe_phase_rehearses_on_the_cpu(monkeypatch,
                                                            capsys):
    """chip_smoke.py's lm_score_moe phase at Arctic's smoke config (bf16
    activations, K5's route) with K5 and K7 swapped for counted plain
    versions: their launches in every shard call, the row and plain-route
    checks, the kernels held on a shard's operands, the drop shares per
    layer."""
    cs = _chip_smoke(monkeypatch)
    counted = fa.flash_attention, rk.rmsnorm
    cfg = get_smoke_config("arctic_480b").replace(act_dtype="bfloat16",
                                                  attention_impl="pallas")
    out = cs.lm_score_phase(torch, np, torch.device("cpu"), cfg, rows=48,
                            seq=20, batches=2, profile=False, hold=True)
    per = cs.expected_launches(cfg)
    assert per == {"flash_attention": 2, "rmsnorm": 5}
    assert out["kernel_launches"] == {k: n * out["calls"]
                                      for k, n in per.items()}
    assert out["ref_rel"] <= cs.LM_REF_REL
    assert {k[0] for k in out["held"]} == set(per)
    assert len(out["drops"]) == cfg.n_layers
    assert all(0.0 <= d < 1.0 for d in out["drops"])
    assert (fa.flash_attention, rk.rmsnorm) == counted
    assert "lm_score_moe" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_lm_serve_moe_phase_rehearses_on_the_cpu(monkeypatch,
                                                            capsys, arch):
    cs = _chip_smoke(monkeypatch)
    for name, value in (("SERVE_BATCH", 2), ("SERVE_PROMPT", 12),
                        ("SERVE_GEN", 5), ("SERVE_FORCED", 3)):
        monkeypatch.setattr(cs, name, value)
    assert arch in dict(cs.SERVE_ARCHS)
    cfg = get_smoke_config(arch).replace(act_dtype="bfloat16")
    out = cs.lm_serve_phase(torch, np, torch.device("cpu"), cfg, " (smoke)",
                            profile=False)
    assert out["launches"] == {"flash_attention": 0, "ssd_scan": 0,
                               "rmsnorm": 5 * 5}
    assert out["rel"] == 0.0 and out["rel_cut"] == 0.0
    assert all(not r <= cs.LM_REF_REL for r in out["planted"].values())
    assert f"lm_serve {cfg.name} (smoke)" in capsys.readouterr().out
