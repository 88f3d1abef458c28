"""The port's Zamba2 hybrid (ROADMAP A13b, its first part) against the JAX
package on the CPU: the smoke forward (the chunked reference attention and
K5's plain version against JAX's Pallas route in interpret mode), the
serving path (prefill, teacher-forced decode, ``serve_wave``), the
converter, the accounting, ``model_op`` through both streaming engines,
and the rehearsals of ``chip_smoke.py``'s Zamba2 phases.

Bars: float32 logits, cache leaves and scores ≤1e-5 relative (max |err| /
max |want|) to JAX's; greedy tokens, accounting and configs equal.  With
bfloat16 activations each side rounds at its own points (XLA fuses
elementwise chains and rounds once, eager torch rounds each op), and with
random weights the gap grows with depth as the reference's own bfloat16
error does: the model cut to its first group (2 Mamba2 layers behind one
attention site) is held at 2e-2, as ``test_torch_ssm.py`` holds Mamba2's
2 layers, and the whole smoke model (5 layers, 3 sites: 2.7e-2 apart)
within JAX's own bfloat16 error against its float32 forward (4.0e-2).
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
from repro.core import ExplicitFleet as JaxFleet  # noqa: E402
from repro.core import uniform_placement as jax_uniform  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.api import analytic_flops as jax_flops  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import count_params as jax_count  # noqa: E402
from repro.streaming import engine as jax_engine  # noqa: E402
from repro.streaming import operators as jax_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.devices import ExplicitFleet  # noqa: E402
from repro_torch.core.placement import uniform_placement  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import analytic_flops, build_model  # noqa: E402
from repro_torch.models import count_params  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.hybrid import HybridCache, Zamba2LM  # noqa: E402
from repro_torch.streaming import operators as port_ops  # noqa: E402
from repro_torch.streaming import StreamGraph, StreamingEngine  # noqa: E402

ARCH = "zamba2_1_2b"
REL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


@functools.lru_cache(maxsize=None)
def _models(act: str = "float32", impl: str = "reference"):
    """The JAX smoke model with ``act`` activations, its parameters, and
    the port's model holding the same parameters on the CPU."""
    jcfg = jax_smoke(ARCH).replace(act_dtype=act)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg)).replace(attention_impl=impl)
    model = convert.zamba2_lm_from_arrays(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jmodel, params, cfg, model


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("S", [16, 20])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_matches_jax(S, act):
    jcfg, jmodel, params, cfg, model = _models(act)
    toks = _tokens(cfg, (2, S), S)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = model({"tokens": toks})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, S, cfg.vocab_padded)
    if act == "float32":
        assert _rel(got, want) <= REL[act]
        return
    # bfloat16 at full smoke depth: within the reference's own bf16 error
    f32, _ = _models()[1].forward(params, {"tokens": jnp.asarray(toks)})
    own = _rel(want, f32)
    assert _rel(got, want) <= max(REL[act], own)
    # and the first group (one site, 2 layers) at the bf16 bar
    cut = jcfg.replace(n_layers=jcfg.shared_attn_every)
    tree = jax.tree.map(np.asarray, params)
    tree["blocks"] = {k: v[:cut.n_layers] for k, v in tree["blocks"].items()}
    jtree = jax.tree.map(jnp.asarray, tree)
    want, _ = jax_build(cut).forward(jtree, {"tokens": jnp.asarray(toks)})
    model = convert.zamba2_lm_from_arrays(
        ModelConfig(**dataclasses.asdict(cut)), tree, device="cpu")
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert _rel(got, want) <= REL[act]


def test_flash_route_matches_jax_pallas_interpret():
    """``attention_impl="pallas"``: K5's route (its plain version on the
    CPU) against the JAX model's Pallas route in interpret mode."""
    jcfg, _, params, cfg, model = _models("float32", "pallas")
    fa.check_shape(2, 16, cfg.n_heads, cfg.hd)
    toks = _tokens(cfg, (2, 16), 3)
    want, _ = jax_build(jcfg.replace(attention_impl="pallas_interpret")) \
        .forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = model({"tokens": toks})
    assert _rel(got, want) <= REL["float32"]


def test_forward_runs_each_kernel_as_the_model_implies(monkeypatch):
    """Through the routes, one forward: K5 once per attention site, K6 once
    per Mamba2 layer, K7 twice per layer, twice per site and once for the
    final norm (5 layers every 2: 3 sites, the last group ragged)."""
    *_, cfg, model = _models("float32", "pallas")
    assert model.n_sites == 3 and model._group(2) == (4, 5)
    calls = {"flash_attention": 0, "ssd_scan": 0, "rmsnorm": 0}

    def count(name):
        fn = getattr(dispatch, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(dispatch, name, count(name))
    with torch.inference_mode():
        model({"tokens": np.zeros((1, 9), np.int64)})
    assert calls == {"flash_attention": 3, "ssd_scan": 5,
                     "rmsnorm": 2 * 5 + 2 * 3 + 1}


def test_prefill_and_teacher_forced_decode_match_jax():
    jcfg, jmodel, params, cfg, model = _models()
    B, S, steps = 2, 12, 8
    prompt, forced = _tokens(cfg, (B, S), 1), _tokens(cfg, (B, steps), 2)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                            jmodel.init_cache(B, S + steps))
    with torch.inference_mode():
        cache = model.init_cache(B, S + steps)
        tl, tc = model.prefill({"tokens": prompt}, cache)
    assert tc is cache and tl.shape == (B, 1, cfg.vocab_padded)
    assert _rel(tl, jl) <= REL["float32"]

    def leaves(c):
        return {"state": c.ssm.state, "conv": c.ssm.conv, "k": c.attn.k,
                "v": c.attn.v}

    for name, leaf in leaves(tc).items():
        want = np.asarray(leaves(jc)[name], np.float32)
        assert tuple(leaf.shape) == want.shape, name
        assert _rel(leaf, want) <= REL["float32"], name
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


def test_decode_continues_from_the_jax_prefill():
    """``convert.cache_from_arrays`` carries JAX's prefilled HybridCache
    across; the port's decode from it matches JAX's decode."""
    jcfg, jmodel, params, cfg, model = _models()
    prompt = _tokens(cfg, (3, 9), 4)
    _, jc = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                           jmodel.init_cache(3, 12))
    cache = convert.cache_from_arrays(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    assert isinstance(cache, HybridCache)
    assert cache.attn.k.shape == (model.n_sites, 3, 12,
                                  cfg.n_kv_heads * cfg.hd)
    tok = _tokens(cfg, (3, 1), 5)
    jl, _ = jmodel.decode_step(params, jc, jnp.int32(9), jnp.asarray(tok))
    with torch.inference_mode():
        tl, _ = model.decode_step(cache, 9, torch.as_tensor(tok))
    assert _rel(tl, jl) <= REL["float32"]


def test_serve_wave_tokens_equal_jax():
    jcfg, jmodel, params, cfg, model = _models()
    prompts = _tokens(cfg, (4, 16), 6)
    want, jstats = jax_serve.serve_wave(jmodel, jcfg, params, prompts, 8)
    got, stats = serve.serve_wave(model, cfg, prompts, 8)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (stats.tokens_out, stats.requests) == (32, 4)


def test_main_serves_the_hybrid_on_the_cpu(capsys):
    s = serve.main(["--arch", "zamba2-1.2b", "--smoke", "--requests", "2",
                    "--batch", "2", "--prompt-len", "6", "--gen", "3",
                    "--device", "cpu"])
    assert (s["requests"], s["tokens_out"]) == (2, 6)
    assert "decode_tok_per_s" in capsys.readouterr().out


def test_config_and_accounting_match_jax():
    for get, jget in ((get_config, jax_config), (get_smoke_config,
                                                 jax_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg, jcfg = get_config("zamba2-1.2b"), jax_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.ssm_state, cfg.ssm_heads, cfg.shared_attn_every,
            cfg.vocab_padded) == (38, 2048, 32, 64, 8192, 64, 64, 6, 32000)
    for c, jc in ((cfg, jcfg), (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert count_params(c) == jax_count(jc)
        for mode in ("train", "prefill", "decode"):
            assert analytic_flops(c, 2048, 11, mode) == \
                jax_flops(jc, 2048, 11, mode)


def test_sites_cover_the_ragged_last_group():
    """38 layers every 6: 7 sites, the last over layers 36–37; the smoke
    config's 5 every 2: 3 sites, the last over layer 4."""
    full = Zamba2LM.__new__(Zamba2LM)
    torch.nn.Module.__init__(full)
    full.cfg = get_config(ARCH)
    assert full.n_sites == 7
    assert [full._group(s) for s in range(7)] == \
        [(0, 6), (6, 12), (12, 18), (18, 24), (24, 30), (30, 36), (36, 38)]
    *_, model = _models()
    assert [model._group(s) for s in range(model.n_sites)] == \
        [(0, 2), (2, 4), (4, 5)]
    cache = model.init_cache(2, 7)
    assert cache.ssm.state.shape[0] == 5 and cache.attn.k.shape[0] == 3


def test_converter_carries_and_refuses():
    jcfg, _, params, cfg, model = _models()
    tree = jax.tree.map(np.asarray, params)
    wq = np.array(tree["shared_attn"]["attn"]["wq"])
    assert torch.equal(model.shared_attn.attn["wq"], torch.from_numpy(wq))
    out4 = np.array(tree["blocks"]["out_proj"][4])
    assert torch.equal(model.blocks[4].out_proj, torch.from_numpy(out4))
    bad = dict(tree, shared_attn=dict(tree["shared_attn"], extra=1))
    with pytest.raises(ValueError, match="not a Zamba2LM tree"):
        convert.zamba2_lm_from_arrays(cfg, bad, device="cpu")
    blocks = dict(tree["blocks"], wz=tree["blocks"]["wz"][:4])
    with pytest.raises(ValueError, match="layers"):
        convert.zamba2_lm_from_arrays(cfg, dict(tree, blocks=blocks),
                                      device="cpu")
    attn = dict(tree["shared_attn"]["attn"], wq=tree["shared_attn"]["attn"][
        "wq"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        convert.zamba2_lm_from_arrays(
            cfg, dict(tree, shared_attn=dict(tree["shared_attn"], attn=attn)),
            device="cpu")


def test_build_model_routes_the_hybrid_and_refuses_no_sites(monkeypatch):
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, Zamba2LM)
    model.init_params(torch.Generator().manual_seed(0))
    again = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    with pytest.raises(ValueError, match="shared_attn_every"):
        build_model(cfg.replace(shared_attn_every=0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)


def test_model_op_through_both_engines_matches_jax():
    """The example's job (ingest → clean → dq_check → lm_score →
    window_mean) with the smoke hybrid as the LM on 12 devices in 3
    regions: row counts and every numpy-side latency bitwise, scores
    within 1e-5."""
    jcfg, jmodel, params, cfg, model = _models()
    vocab = cfg.vocab
    scores = {"jax": [], "port": []}

    def capture(op, sink):
        fn = op.fn
        op.fn = lambda rows: sink.append(fn(rows)) or sink[-1]
        return op

    def ops(mod, lm, key):
        return [mod.source("ingest"),
                mod.map_op("clean", lambda r: np.clip(r, 0, vocab - 1),
                           work=0.5),
                mod.quality_op("dq_check", threshold=0.4, work=2.0),
                capture(lm, scores[key]),
                mod.window_agg("window_mean", window=8, work=0.5)]

    edges = [(0, 1), (1, 2), (2, 3), (3, 4)]
    jg = jax_ops.StreamGraph(ops(jax_ops, jax_ops.model_op(
        "lm_score", jmodel, params, jcfg, work=50.0), "jax"), edges)
    g = StreamGraph(ops(port_ops, port_ops.model_op("lm_score", model,
                                                    work=50.0), "port"),
                    edges)
    rng = np.random.default_rng(0)
    region = np.repeat(np.arange(3), 4)
    wan = np.array([[0.02, 1.5, 2.5], [1.5, 0.02, 1.0], [2.5, 1.0, 0.02]])
    com = wan[np.ix_(region, region)] + rng.uniform(0, 0.05, (12, 12))
    com = (com + com.T) / 2
    np.fill_diagonal(com, 0.0)
    speed = np.where(region == 0, 2.0, 1.0)
    jfleet = JaxFleet(com_cost=com, speed=speed, region=region)
    fleet = ExplicitFleet(com_cost=com, speed=speed, region=region)
    jeng = jax_engine.StreamingEngine(
        jg, jfleet, jax_uniform(5, jfleet.availability(5)), alpha=0.002,
        device_speed=speed.copy(), observed="work")
    eng = StreamingEngine(g, fleet, uniform_placement(5,
                                                      fleet.availability(5)),
                          alpha=0.002, device_speed=speed.copy(),
                          observed="work")
    for _ in range(2):
        batch = rng.integers(0, vocab, (48, 16)).astype(float)
        batch[rng.random(48) < 0.05] = -1
        rep, jrep = eng.run_batch(batch), jeng.run_batch(batch)
        assert rep.rows_in == jrep.rows_in and rep.rows_out == jrep.rows_out
        for f in ("modeled_latency", "edge_latencies", "device_busy",
                  "op_rows_in", "op_rows_out"):
            assert np.array_equal(getattr(rep, f), getattr(jrep, f)), f
    got, want = np.concatenate(scores["port"]), np.concatenate(scores["jax"])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert len(got) >= 2 * 30 and _rel(got, want) <= REL["float32"]


# ------------------------------------------------ chip_smoke rehearsals ---

def _chip_smoke(monkeypatch):
    """chip_smoke imported from the repository root, K5, K6 and K7 routed
    to counted plain versions on the CPU, the card's memory counters
    stubbed, the launch counts restored after the test."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))

    def counted_attn(q, k, v, causal=True):
        fa.launches["flash_attention"] += 1
        return ref.flash_attention_plain(q, k, v, causal=causal)

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
                        if kind in ("flash_attention", "ssd_scan", "rmsnorm")
                        else plan(kind, what, t))
    monkeypatch.setattr(fa, "flash_attention", counted_attn)
    monkeypatch.setattr(sk, "ssd_scan", counted_ssd)
    monkeypatch.setattr(rk, "rmsnorm", counted_rms)
    for name in ("reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    return chip_smoke


def test_chip_smoke_expected_launches_learn_the_hybrid():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    full = get_config(ARCH)
    assert chip_smoke.expected_launches(
        full.replace(attention_impl="pallas")) == {
        "flash_attention": 7, "ssd_scan": 38, "rmsnorm": 2 * 38 + 14 + 1}
    assert chip_smoke.expected_launches(full)["flash_attention"] == 0
    assert "K6 state dropped" in chip_smoke.wrong_ssm_kernels(torch, full)


def test_chip_smoke_lm_score_zamba2_phase_rehearses_on_the_cpu(monkeypatch,
                                                               capsys):
    """chip_smoke.py's lm_score_zamba2 phase at the smoke config (bf16
    activations, K5's route) on the CPU with K5, K6 and K7 swapped for
    counted plain versions: each launched as the model implies in every
    shard call, the row and plain-route checks pass, the kernels are held
    on the operands a shard hands them, and every swap is undone."""
    cs = _chip_smoke(monkeypatch)
    counted = fa.flash_attention, sk.ssd_scan, rk.rmsnorm
    cfg = get_smoke_config(ARCH).replace(act_dtype="bfloat16",
                                         attention_impl="pallas")
    out = cs.lm_score_phase(torch, np, torch.device("cpu"), cfg, rows=48,
                            seq=20, batches=2, profile=False, hold=True)
    per = cs.expected_launches(cfg)
    assert per == {"flash_attention": 3, "ssd_scan": 5, "rmsnorm": 17}
    assert out["calls"] >= 24
    assert out["kernel_launches"] == {k: n * out["calls"]
                                      for k, n in per.items()}
    assert out["ref_rel"] <= cs.LM_REF_REL
    assert {k[0] for k in out["held"]} == set(per)
    assert all(h["rel_err"] <= h["bar"] and h["library_ms"] is None
               for h in out["held"].values())
    assert (fa.flash_attention, sk.ssd_scan, rk.rmsnorm) == counted
    assert "lm_score_zamba2" in capsys.readouterr().out


def test_chip_smoke_lm_serve_zamba2_phase_rehearses_on_the_cpu(monkeypatch,
                                                               capsys):
    """chip_smoke.py's lm_serve phase with the smoke hybrid: K7 per prefill
    and decode step, K6 per prefill layer, no K5 (the cache routes
    attention to ``_sdpa_chunked``), the plain-route checks and both
    planted faults failing them."""
    cs = _chip_smoke(monkeypatch)
    for name, value in (("SERVE_BATCH", 2), ("SERVE_PROMPT", 12),
                        ("SERVE_GEN", 5), ("SERVE_FORCED", 3)):
        monkeypatch.setattr(cs, name, value)
    assert (ARCH, None) in cs.SERVE_ARCHS
    cfg = get_smoke_config(ARCH)
    out = cs.lm_serve_phase(torch, np, torch.device("cpu"), cfg, " (smoke)",
                            profile=False)
    per = cs.expected_launches(cfg)
    assert out["launches"] == {"flash_attention": 0, "ssd_scan": 5,
                               "rmsnorm": per["rmsnorm"] * 5}
    assert out["rel"] == 0.0 and out["rel_cut"] == 0.0
    assert set(out["planted"]) == {"K7 rows shifted", "K6 state dropped"}
    assert all(not r <= cs.LM_REF_REL for r in out["planted"].values())
    bar_cut = max(cs.LM_REF_REL, out["own_cut"])
    assert all(not r <= bar_cut for r in out["planted_cut"].values())
    assert f"lm_serve {cfg.name} (smoke)" in capsys.readouterr().out
