"""The port's training slice against the JAX package on the CPU: the 8-bit
quantizer and error feedback (bitwise), AdamW over three steps with
clipping engaged (f32 and 8-bit moments) and its stacked-ndim weight
decay, K7's plain backward against ``jax.vjp`` of ``rms_norm``, the remat
modes, the cotangent cast, the embedding gradient, the data pipeline, the trainer
against the reference's trainer and at ``examples/train_lm.py``'s
configuration, the refusals of the card routes under grad, and the
rehearsal of ``chip_smoke.py``'s ``lm_train`` phase.  One train step per
family is held against the reference in ``test_torch_train_step.py``.

Bars: float32 losses, gradient norms, gradients and parameters ≤1e-5
relative (max |err| / max |want|) to JAX's; AdamW on identical gradients
≤1e-6; quantizer, error feedback, pipeline and the remat modes bitwise;
bfloat16 gradients within one bfloat16 ulp of the largest (≤1e-2)."""

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
from repro.data import pipeline as jax_pipe  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train import compress as jax_compress  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.transformer import remat_wrap  # noqa: E402
from repro_torch.train import compress, optim, steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
FAMILIES = {"granite_8b": convert.decoder_lm_from_arrays,
            "olmo_1b": convert.decoder_lm_from_arrays,
            "mamba2_1_3b": convert.mamba2_lm_from_arrays,
            "zamba2_1_2b": convert.zamba2_lm_from_arrays,
            "arctic_480b": convert.decoder_lm_from_arrays,
            "llama_3_2_vision_11b": convert.vision_lm_from_arrays,
            "whisper_large_v3": convert.enc_dec_lm_from_arrays}
GATES = (0.8, -0.5, 0.3)


@pytest.fixture
def one_thread():
    """One intra-op thread for a loop of many small CPU ops: as fast alone,
    and not slowed by spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _ref_leaf(tree, name: str):
    """The reference's leaf of the port's parameter ``name``: a per-layer
    module's parameter is slice i of the stacked leaf (of each part of an
    8-bit moment's {"q", "scale"})."""
    parts = name.split(".")
    idx = None
    if len(parts) > 1 and parts[1].isdigit():
        idx, parts = int(parts[1]), [parts[0]] + parts[2:]
    leaf = tree
    for p in parts:
        leaf = leaf[p]
    if idx is None:
        return leaf
    if isinstance(leaf, dict):
        return {k: np.asarray(v)[idx] for k, v in leaf.items()}
    return leaf[idx]


@functools.lru_cache(maxsize=None)
def _jax_models(arch: str):
    """The JAX smoke model of ``arch``, its parameters (the VLM's gates
    opened) as numpy arrays and the port's config."""
    jcfg = jax_smoke(arch)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        params["cross"]["gate"] = jnp.asarray(GATES[:jmodel.n_cross],
                                              jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, jmodel, tree, ModelConfig(**dataclasses.asdict(jcfg))


def _port_model(arch: str):
    _, _, tree, cfg = _jax_models(arch)
    return FAMILIES[arch](cfg, tree, device="cpu")


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    out = {"tokens": t[:, :-1], "labels": t[:, 1:],
           "loss_mask": (rng.random((B, S)) > 0.25).astype(np.float32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


# -- quantizer, error feedback -------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (3, 130), (2, 4, 33)])
def test_quantize_blockwise_is_bitwise_the_reference(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    x = np.asarray(rng.standard_normal(shape) * 3, dtype=np.float32)
    if x.size > 2:
        x.reshape(-1)[:2] = 0.0
        x.reshape(-1)[2] = 127.5 * 0.25   # a .5 tie: round to even
    want = jax_optim.quantize_blockwise(jnp.asarray(x))
    got = optim.quantize_blockwise(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and tuple(got["q"].shape) == shape
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        optim.dequantize_blockwise(got, shape).numpy(),
        np.asarray(jax_optim.dequantize_blockwise(want, shape)))
    z = optim.quantize_blockwise(torch.zeros(shape))
    assert not z["q"].any()


def test_error_feedback_is_bitwise_the_reference():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((4, 40)).astype(np.float32),
             "b": rng.standard_normal((9,)).astype(np.float32)}
    err_t = compress.ErrorFeedbackState.init(
        {k: torch.from_numpy(v) for k, v in grads.items()})
    err_j = jax_compress.ErrorFeedbackState.init(
        {k: jnp.asarray(v) for k, v in grads.items()})
    for step in range(3):
        g = {k: v * (step + 1) for k, v in grads.items()}
        sent_t, err_t = compress.ErrorFeedbackState.step(
            {k: torch.from_numpy(v) for k, v in g.items()}, err_t)
        sent_j, err_j = jax_compress.ErrorFeedbackState.step(
            {k: jnp.asarray(v) for k, v in g.items()}, err_j)
        for k in g:
            np.testing.assert_array_equal(sent_t[k].numpy(),
                                          np.asarray(sent_j[k]))
            np.testing.assert_array_equal(err_t[k].numpy(),
                                          np.asarray(err_j[k]))
    x = rng.standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        compress.compress_decompress(torch.from_numpy(x)).numpy(),
        np.asarray(jax_compress.compress_decompress(jnp.asarray(x))))


# -- AdamW ---------------------------------------------------------------------

def _adamw_trees(rng):
    """A stacked reference tree (two layers) and the port's per-layer
    parameters holding the same values."""
    tree = {"embed": rng.standard_normal((12, 8)),
            "blocks": {"ln1": 1 + 0.1 * rng.standard_normal((2, 8)),
                       "w": rng.standard_normal((2, 8, 5)),
                       "A_log": rng.standard_normal((2, 3))},
            "final_norm": 1 + 0.1 * rng.standard_normal(8)}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    port = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i in range(2):
        for k, v in tree["blocks"].items():
            port[f"blocks.{i}.{k}"] = v[i]
    return tree, {k: torch.tensor(v) for k, v in port.items()}


@pytest.mark.parametrize("bits8", [False, True])
def test_adamw_update_matches_the_reference(bits8):
    """Three steps on identical gradients, the global norm clipped
    (grad_clip 0.5 against norms ≈ 10): parameters, moments and norms
    ≤1e-6 relative; the 8-bit moments' int8 codes equal."""
    rng = np.random.default_rng(5)
    tree, params = _adamw_trees(rng)
    jcfg = jax_optim.AdamWConfig(lr=1e-2, grad_clip=0.5, bits8=bits8)
    cfg = optim.AdamWConfig(lr=1e-2, grad_clip=0.5, bits8=bits8)
    jstate = jax_optim.adamw_init(jax.tree.map(jnp.asarray, tree), jcfg)
    state = optim.adamw_init(params, cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    for step in range(3):
        gtree = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        grads = {k: torch.tensor(_ref_leaf(gtree, k)) for k in params}
        jparams, jstate, jnorm = jax_optim.adamw_update(
            jax.tree.map(jnp.asarray, gtree), jstate, jparams, jcfg)
        params, state, gnorm = optim.adamw_update(grads, state, params, cfg)
        assert float(jnorm) > 0.5
        assert _rel(gnorm, jnorm) <= 1e-6
        assert int(state["count"]) == int(jstate["count"]) == step + 1
    jp = jax.tree.map(np.asarray, jparams)
    moments = {mom: jax.tree.map(np.asarray, jstate[mom])
               for mom in ("m", "v")}
    for name, p in params.items():
        assert _rel(p, _ref_leaf(jp, name)) <= 1e-6, name
        for mom in ("m", "v"):
            got, want = state[mom][name], _ref_leaf(moments[mom], name)
            if bits8:
                want = {k: np.asarray(v) for k, v in want.items()}
                np.testing.assert_array_equal(got["q"].numpy(), want["q"])
                assert _rel(got["scale"], want["scale"]) <= 1e-6
            else:
                assert _rel(got, want) <= 1e-6, (mom, name)


def test_decay_follows_the_references_stacked_ndim():
    """With zero gradients AdamW's update is the decay alone: the
    per-layer norm weights and ``A_log`` (stacked (L, …) in the
    reference) decay, ``final_norm`` (unstacked, 1-D) does not — as the
    reference; a rule on the port's own ndim would leave the per-layer
    1-D tensors undecayed."""
    rng = np.random.default_rng(6)
    tree, params = _adamw_trees(rng)
    before = {k: v.clone() for k, v in params.items()}
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.5)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    optim.adamw_update(grads, optim.adamw_init(params, cfg), params, cfg)
    jp, _, _ = jax_optim.adamw_update(
        jax.tree.map(jnp.zeros_like, tree),
        jax_optim.adamw_init(jax.tree.map(jnp.asarray, tree),
                             jax_optim.AdamWConfig(lr=0.1, weight_decay=0.5)),
        jax.tree.map(jnp.asarray, tree),
        jax_optim.AdamWConfig(lr=0.1, weight_decay=0.5))
    jp = jax.tree.map(np.asarray, jp)
    for name, p in params.items():
        decayed = not torch.equal(p, before[name])
        assert decayed == (name != "final_norm"), name
        assert _rel(p, _ref_leaf(jp, name)) <= 1e-6, name
    assert optim.stacked_ndim("blocks.3.ln1", torch.zeros(8)) == 2
    assert optim.stacked_ndim("cross.0.gate", torch.zeros(())) == 1
    assert optim.stacked_ndim("shared_attn.ln1", torch.zeros(8)) == 1
    assert optim.stacked_ndim("embed", torch.zeros(3, 8)) == 2


# -- K7's plain backward -------------------------------------------------------

@pytest.mark.parametrize("dtype,bar", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rmsnorm_plain_backward_matches_jax_vjp(dtype, bar):
    """``ref.rmsnorm_bwd_plain`` (the plain version K7's backward is held
    against) against ``jax.vjp(repro.models.layers.rms_norm)``: dx in x's
    dtype, dw in float32; bfloat16 within one ulp of the largest."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 5, 96)).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(96)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(jax_layers.rms_norm, jnp.asarray(x, jd), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jd))
    td = getattr(torch, dtype)
    dx, dw = ref.rmsnorm_bwd_plain(torch.tensor(x).to(td), torch.tensor(w),
                                   torch.tensor(g).to(td))
    assert dx.dtype == td and dw.dtype == torch.float32
    assert _rel(_np(dx), np.asarray(jdx, np.float32)) <= bar
    assert _rel(dw, np.asarray(jdw, np.float32)) <= max(bar, 1e-5)


# -- remat, the cotangent cast, the embedding gradient ------------------------

@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_1_3b", "zamba2_1_2b",
                                  "whisper_large_v3"])
def test_remat_modes_give_the_gradients_of_none_bitwise(arch):
    _, _, _, cfg = _jax_models(arch)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg, 2, 10, seed=9).items()}
    got = {}
    for mode in ("none", "full", "dots"):
        mcfg = cfg.replace(remat=mode)
        model = FAMILIES[arch](mcfg, _jax_models(arch)[2], device="cpu")
        loss, _, grads = steps.make_grad_fn(model, mcfg)(batch)
        got[mode] = (loss, grads)
    for mode in ("full", "dots"):
        assert torch.equal(got[mode][0], got["none"][0])
        for name, g in got["none"][1].items():
            assert torch.equal(got[mode][1][name], g), (mode, name)
    with pytest.raises(ValueError, match="remat"):
        remat_wrap(lambda x: x, "some")


def test_full_remat_reruns_each_block_in_the_backward():
    """Under "full" each block's forward runs twice in a training step
    (once more in the backward), under "none" once; serving (no grad) runs
    it once in any mode."""
    _, _, tree, cfg = _jax_models("granite_8b")
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg, 2, 6, seed=2).items()}
    for mode, want in (("none", 1), ("full", 2), ("dots", 2)):
        model = convert.decoder_lm_from_arrays(cfg.replace(remat=mode), tree,
                                               device="cpu")
        calls = []
        saved = model._block
        model._block = lambda *a, **k: (calls.append(1), saved(*a, **k))[1]
        steps.make_grad_fn(model, model.cfg)(batch)
        assert len(calls) == want * cfg.n_layers, mode
        calls.clear()
        with torch.inference_mode():
            model(batch)
        assert len(calls) == cfg.n_layers


def test_cotangent_cast_casts_what_torch_already_casts():
    """Torch's ``.float()`` (``ToCopyBackward``) hands back a gradient in
    the bf16 input's dtype already, so ``cotangent_cast`` is a no-op on the
    head's path, as the reference measured its own; on a float32 gradient
    it casts, and it is the identity forward."""
    x = torch.randn(3, 4, dtype=torch.bfloat16, requires_grad=True)
    (g,) = torch.autograd.grad((x.float() * 3).sum(), x)
    assert g.dtype == torch.bfloat16
    y = layers.cotangent_cast(x)
    assert torch.equal(y, x) and y.grad_fn is not None
    (g,) = torch.autograd.grad(y, x, torch.ones(3, 4, dtype=torch.float32)
                               .to(torch.bfloat16))
    assert g.dtype == torch.bfloat16

    class Up(torch.autograd.Function):    # a head that promotes the grad
        @staticmethod
        def forward(ctx, t):
            return t.float()

        @staticmethod
        def backward(ctx, gt):
            return gt       # float32, not cast back

    (g,) = torch.autograd.grad(Up.apply(layers.cotangent_cast(x)).sum(), x)
    assert g.dtype == torch.bfloat16
    with torch.no_grad():
        assert layers.cotangent_cast(x) is x


@pytest.mark.parametrize("S", [40, 1100])
def test_embedding_gradient_mirrors_the_one_hot_matmul(S):
    """At bf16 activations the reference's embedding is a one-hot matmul
    in bf16, so its table gradient is a bf16 product per 512-position
    chunk, summed in bf16; ``F.embedding``'s own backward would sum in
    float32.  The port's equals the reference's (within one bf16 ulp of
    the largest: the float32 sums run in another order) and differs from
    the float32 one by that rounding."""
    rng = np.random.default_rng(11)
    V, d = 48, 16
    table = rng.standard_normal((V, d)).astype(np.float32)
    tokens = rng.integers(0, V, (2, S), dtype=np.int32)
    g = rng.standard_normal((2, S, d)).astype(np.float32)

    def jax_emb(t):
        return jax_layers.embed_lookup(t, jnp.asarray(tokens), jnp.bfloat16)

    _, vjp = jax.vjp(jax_emb, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    t = torch.tensor(table, requires_grad=True)
    out = layers.embed_lookup(t, torch.as_tensor(tokens), torch.bfloat16)
    (got,) = torch.autograd.grad(out, t, torch.tensor(g).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and got.dtype == torch.float32
    assert _rel(got, want) <= 2 ** -8
    f32 = torch.nn.functional.embedding(torch.as_tensor(tokens).long(), t)
    (plain,) = torch.autograd.grad(f32.to(torch.bfloat16), t,
                                   torch.tensor(g).to(torch.bfloat16))
    # the bf16-rounded gradient is representable in bf16; F.embedding's
    # float32 sums are not
    assert torch.equal(got, got.to(torch.bfloat16).float())
    assert not torch.equal(plain, plain.to(torch.bfloat16).float())


# -- the data pipeline ---------------------------------------------------------

@pytest.mark.parametrize("dq", [0.0, 0.5])
def test_token_stream_and_prefetcher_are_bitwise_the_reference(dq):
    kw = dict(vocab=257, seq_len=24, global_batch=64, seed=3,
              dq_fraction=dq, dq_missing_rate=0.2)
    ours = pipeline.TokenStream(pipeline.PipelineConfig(**kw), cursor=17)
    theirs = jax_pipe.TokenStream(jax_pipe.PipelineConfig(**kw), cursor=17)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if dq:
        assert (a["loss_mask"] == 0).any() and (a["loss_mask"] == 1).any()
    resumed = pipeline.TokenStream.from_state(ours.cfg, ours.state())
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  theirs.next_batch()["tokens"])
    with pytest.raises(ValueError, match="seed"):
        pipeline.TokenStream.from_state(ours.cfg, {"cursor": 0, "seed": 9})
    pre = pipeline.Prefetcher(pipeline.TokenStream(ours.cfg))
    direct = jax_pipe.TokenStream(theirs.cfg)
    try:
        for _ in range(4):
            a, b = pre.next(), direct.next_batch()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        pre.close()
    assert not pre.thread.is_alive()


# -- the trainer ---------------------------------------------------------------

def test_run_training_matches_the_reference_trainer(one_thread):
    """``run_training`` from the reference trainer's own initial weights
    (``init_params(PRNGKey(0))``), with the DQ mask, logging every step:
    the same losses ≤1e-5 relative, and the final parameters ≤1e-4 (five
    Adam steps: an element whose gradient sits at float32's roundoff floor
    moves by ±lr in either package, see ``test_torch_train_step.py``)."""
    jcfg, jmodel, tree, cfg = _jax_models("granite_8b")
    kw = dict(steps=5, global_batch=4, seq_len=16, lr=1e-3,
              dq_fraction=0.5, log_every=1)
    want = jax_train.run_training(jcfg, **kw)
    got = run_training(cfg, model=_port_model("granite_8b"), **kw)
    assert [s for s, _ in got["losses"]] == [s for s, _ in want["losses"]]
    for (_, a), (_, b) in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= REL * abs(b)
    jp = jax.tree.map(np.asarray, want["params"])
    for name, p in got["model"].named_parameters():
        assert _rel(_np(p), _ref_leaf(jp, name)) <= 1e-4, name


def test_trainer_lowers_the_loss_at_the_example_configuration(one_thread):
    """``examples/train_lm.py``'s configuration (granite smoke at 4 layers,
    d 128, d_ff 256; batch 8 × 64, lr 1e-3, a quarter of the stream
    quality-checked), cut to 60 of its 200 steps: the loss falls."""
    cfg = get_smoke_config("granite_8b").replace(n_layers=4, d_model=128,
                                                 d_ff=256)
    out = run_training(cfg, steps=60, global_batch=8, seq_len=64, lr=1e-3,
                       dq_fraction=0.25, log_every=20, device="cpu")
    first, last = out["losses"][0][1], out["losses"][-1][1]
    assert [s for s, _ in out["losses"]] == [20, 40, 60]
    assert last < first


# -- refusals and the card route under grad ------------------------------------

def test_training_refuses_the_flash_route():
    cfg = get_smoke_config("granite_8b").replace(attention_impl="pallas")
    with pytest.raises(ValueError, match="K5 has no backward"):
        run_training(cfg, steps=1, global_batch=2, seq_len=8, device="cpu")
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="reference"):
        steps.make_train_step(model, cfg, optim.AdamWConfig())


def test_card_routes_without_a_backward_raise_under_grad(monkeypatch):
    """Every card route but K7's and K6's raises under grad instead of
    returning a tensor without a ``grad_fn``: the plan says "cuda" for these
    CPU tensors, and the wrappers are never reached.  K5's refusal states
    its decision (no backward, as the reference's Pallas kernel has none);
    K6 under grad goes on to its wrapper (its autograd function)."""
    from repro_torch.kernels import edge_latency as ek
    from repro_torch.kernels import flash_attention as fa

    def never(*a, **k):
        raise AssertionError("a kernel wrapper was reached under grad")

    monkeypatch.setattr(dispatch, "_plan", lambda *a, **k: "cuda")
    for mod, names in ((ek, ("edge_latency_dense", "edge_latency_structured",
                             "edge_latency_dense_single_tile",
                             "edge_latency_structured_single_tile")),
                       (fa, ("flash_attention",)), (sk, ("ssd_scan",))):
        for n in names:
            monkeypatch.setattr(mod, n, never)
    x = torch.rand(2, 3, 5, requires_grad=True)
    com = torch.rand(1, 5, 5)
    mass, a, corr = torch.rand(2, 3, 2), torch.rand(1, 2, 5), \
        torch.rand(1, 1, 5)
    q = torch.rand(1, 8, 2, 4, requires_grad=True)
    sx = torch.rand(1, 8, 2, 4, requires_grad=True)
    B = torch.rand(1, 8, 3)
    calls = {
        "K1": lambda: dispatch.edge_latency(x, x, com),
        "K2": lambda: dispatch.edge_latency_structured(x, x, mass, a, corr),
        "K4a": lambda: dispatch.edge_latency_single_tile(x, x, com),
        "K4b": lambda: dispatch.edge_latency_structured_single_tile(
            x, x, mass, a, corr),
        "K5": lambda: dispatch.flash_attention(q, q, q)}
    for k, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward.*ROADMAP"):
            call()
    with pytest.raises(RuntimeError, match="B2, decided against"):
        calls["K5"]()
    with pytest.raises(AssertionError, match="reached"):
        dispatch.ssd_scan(sx, B, B, torch.rand(1, 8, 2), -torch.rand(2),
                          torch.rand(2), 4)
    with torch.no_grad():       # without grad the route is taken as before
        with pytest.raises(AssertionError, match="reached"):
            calls["K5"]()


def test_k7_card_route_differentiates_through_its_backward(monkeypatch):
    """K7's card route under grad is ``RMSNormFunction``: its forward is the
    wrapper's ``rmsnorm``, its backward ``rmsnorm_bwd`` (here the plain
    versions, counted, on CPU tensors the plan calls "cuda"); the output
    has a ``grad_fn`` and the gradients are plain autograd's."""
    count = {"fwd": 0, "bwd": 0}

    def fwd(x, w, eps=1e-6):
        count["fwd"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    def bwd(x, w, g, eps=1e-6):
        count["bwd"] += 1
        return ref.rmsnorm_bwd_plain(x, w, g, eps)

    monkeypatch.setattr(dispatch, "_plan", lambda *a, **k: "cuda")
    monkeypatch.setattr(rk, "rmsnorm", fwd)
    monkeypatch.setattr(rk, "rmsnorm_bwd", bwd)
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal((4, 6, 32)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor((1 + rng.random(32)).astype(np.float32),
                     requires_grad=True)
    y = dispatch.rmsnorm(x, w)
    assert y.grad_fn is not None and count == {"fwd": 1, "bwd": 0}
    g = torch.tensor(rng.standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, (x, w), g)
    assert count == {"fwd": 1, "bwd": 1}
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    want = torch.autograd.grad(ref.rmsnorm_plain(xs, ws), (xs, ws), g)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    with torch.no_grad():
        assert dispatch.rmsnorm(x, w).grad_fn is None
    assert count["fwd"] == 2


def test_k7_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """The backward's wrapper takes CUDA tensors only (the plain version
    serves CPU tensors) and launches nothing here; its roofline terms are
    x and g read and dx written once, w read and dw written once."""
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rk.rmsnorm_bwd(x, torch.ones(8), x)
    assert rk.launches["rmsnorm_bwd"] == 0
    from repro_torch.perf import roofline
    t = roofline.rmsnorm_bwd_terms(8192, 4096, torch.bfloat16)
    assert t.bytes == 3 * 8192 * 4096 * 2 + 8 * 4096
    assert t.bound_by == "bytes" and abs(t.memory_s - 6.0107e-5) < 1e-8


# -- chip_smoke's lm_train phase, rehearsed ------------------------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_lm_train_phase_rehearses_on_the_cpu(monkeypatch,
                                                        tmp_path, one_thread):
    """``chip_smoke.lm_train_phase`` at the granite smoke widths on the CPU,
    K7 and its backward swapped for counted plain versions under the card
    plan: the step-1 gradient of every parameter finite and non-zero, K7's
    backward held on the operands the path hands it, step 1 against the
    plain route at 2 layers and the cut depth with the planted backward
    fault failing, the launch counts of ``expected_launches(mode="train")``,
    the refusals, and die-and-resume equal to the uninterrupted run."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")

    def fwd(x, w, eps=1e-6):
        rk.launches["rmsnorm"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    def bwd(x, w, g, eps=1e-6):
        rk.launches["rmsnorm_bwd"] += 1
        return ref.rmsnorm_bwd_plain(x, w, g, eps)

    def scan(x, B, C, dt, A, D, chunk, final_state=False, state_out=None):
        sk.launches["ssd_scan"] += 1
        return ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, final_state,
                                  state_out)

    def scan_bwd(x, B, C, dt, A, D, dy, chunk):
        sk.launches["ssd_scan_bwd"] += 1
        return ref.ssd_scan_bwd_plain(x, B, C, dt, A, D, dy, chunk)

    real_plan = dispatch._plan
    card = ("rmsnorm", "flash_attention", "ssd_scan")
    monkeypatch.setattr(dispatch, "_plan", lambda kind, what, ts: (
        "cuda" if kind in card else real_plan(kind, what, ts)))
    monkeypatch.setattr(rk, "rmsnorm", fwd)
    monkeypatch.setattr(rk, "rmsnorm_bwd", bwd)
    monkeypatch.setattr(sk, "ssd_scan", scan)
    monkeypatch.setattr(sk, "ssd_scan_bwd", scan_bwd)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_profile", lambda *a, **k: "not measured")
    cfg = get_smoke_config("granite_8b").replace(n_layers=3,
                                                 act_dtype="bfloat16")
    out = cs.lm_train_phase(torch, np, torch.device("cpu"), cfg,
                            batch=2, seq=16, n_steps=3,
                            resume_cfg=get_smoke_config("granite_8b"),
                            ckpt_root=tmp_path, profile=False)
    want = cs.expected_launches(cfg, "train")
    assert out["launches_per_step"] == want
    assert want["rmsnorm_bwd"] == 2 * 3 + 1
    assert want["rmsnorm"] == (2 * 3 + 1) + 2 * 3
    assert out["resume_bitwise"]
    assert out["held"] and all(h["rel_err"] <= h["bar"]
                               for h in out["held"].values())
    assert out["planted_fails"]
    assert out["masked"] > 0
    assert len(out["refused"]) == 2 and out["k6_grad"]


@pytest.mark.parametrize("raised, passes", [
    (RuntimeError("K5: the CUDA kernel has no backward (ROADMAP B2)"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("no backward (ROADMAP B2)"), False),
    (None, False),
])
def test_chip_smoke_refusal_takes_only_the_no_backward_refusal(raised,
                                                               passes):
    """``chip_smoke.refusal`` passes a route only on the refusal it asks
    for: the error's type, "no backward" and the ROADMAP item; any other
    error, or none, fails the phase."""
    cs = _chip_smoke()

    def call():
        if raised is not None:
            raise raised

    if passes:
        assert cs.refusal("p", "K5", RuntimeError, call).startswith("K5: ")
    else:
        with pytest.raises((AssertionError, ValueError)):
            cs.refusal("p", "K5", RuntimeError, call)
