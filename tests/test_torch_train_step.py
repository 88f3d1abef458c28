"""One ``make_train_step`` step of the port against the JAX package's jitted
step on the CPU, for the smoke config of every family (granite, olmo,
mamba2, zamba2, arctic, llama-vision, whisper): one batch, and the same
batch as two microbatches with 8-bit moments (so the accumulator is bf16,
as the reference's; OLMo with float32 moments, see ``CASES``), plus
granite with two microbatches and float32 moments.  Same parameters (the reference's ``init_params(PRNGKey(0))``
through ``repro_torch.convert``; the VLM's gates opened), same batch (a
loss mask, the model's extras).

Bars, each against the reference:

* loss, MoE aux and gradient norm ≤1e-5 relative;
* the gradients AdamW was handed, leaf by leaf of the reference's tree (a
  per-layer parameter's gradients stacked over the layers, as there),
  ≤1e-5 relative (max |err| / max |want|); a bf16 accumulator within one
  bf16 ulp of the
  largest (≤1e-2: each microbatch's scaled gradient is rounded to bf16
  from float32 values that differ in their last bits);
* the updated parameters equal the reference's ``adamw_update`` applied to
  the port's own gradients, ≤1e-6.  They are not held to JAX's updated
  parameters directly: Adam's first step divides each gradient by its own
  magnitude, so an element whose gradient is at float32's roundoff floor
  (|g| ~ 1e-8 where the leaf's largest is 0.05) moves by ±lr either way —
  the reference is not determined there to 1e-5 by its own float32.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.train import optim, steps  # noqa: E402

FAMILIES = {"granite_8b": convert.decoder_lm_from_arrays,
            "olmo_1b": convert.decoder_lm_from_arrays,
            "mamba2_1_3b": convert.mamba2_lm_from_arrays,
            "zamba2_1_2b": convert.zamba2_lm_from_arrays,
            "arctic_480b": convert.decoder_lm_from_arrays,
            "llama_3_2_vision_11b": convert.vision_lm_from_arrays,
            "whisper_large_v3": convert.enc_dec_lm_from_arrays}
GATES = (0.8, -0.5, 0.3)
# 8-bit moments with two microbatches for every family but OLMo: the
# reference's 8-bit ``adamw_init`` raises on OLMo's (L, 0) placeholder
# leaves of its non-parametric norms (``jnp.max`` over an empty axis; it
# takes 8-bit moments only for bf16 parameters, none of which has one);
# OLMo and granite take float32 moments with two microbatches instead
CASES = [(arch, 1, False) for arch in FAMILIES] \
    + [(arch, 2, arch != "olmo_1b") for arch in FAMILIES] \
    + [("granite_8b", 2, False)]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:        # a non-parametric norm's placeholder
        return 0.0
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _ref_leaf(tree, name: str):
    """The reference's leaf of the port's parameter ``name``: a per-layer
    module's parameter is slice i of the stacked leaf."""
    parts = name.split(".")
    idx = None
    if len(parts) > 1 and parts[1].isdigit():
        idx, parts = int(parts[1]), [parts[0]] + parts[2:]
    leaf = tree
    for p in parts:
        leaf = leaf[p]
    return leaf if idx is None else np.asarray(leaf)[idx]


def _stacked(tree, flat: dict, prefix: str = ""):
    """``tree``'s structure filled from the port's per-parameter tensors:
    a per-layer parameter stacked over its modules, a non-parametric
    norm's placeholder as zeros."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out[k] = _stacked(v, flat, path)
        elif path in flat:
            out[k] = _np(flat[path])
        else:
            top, _, rest = path.partition(".")
            names = [f"{top}.{i}.{rest}" for i in range(v.shape[0])]
            out[k] = np.stack([_np(flat[n]) for n in names]) \
                if names and all(n in flat for n in names) \
                else np.zeros_like(v)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    jcfg = jax_smoke(arch)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        params["cross"]["gate"] = jnp.asarray(GATES[:jmodel.n_cross],
                                              jnp.float32)
    return jcfg, jmodel, jax.tree.map(np.asarray, params)


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


@pytest.mark.parametrize("arch,micro,bits8", CASES,
                         ids=[f"{a}-mb{m}-{'bits8' if b else 'f32'}"
                              for a, m, b in CASES])
def test_train_step_matches_the_reference(monkeypatch, arch, micro, bits8):
    jcfg, jmodel, tree = _reference(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = FAMILIES[arch](cfg, tree, device="cpu")
    batch = _batch(cfg, 4, 12, seed=len(arch) + micro)

    def record(update):   # the reference's AdamW, handing back its grads
        def wrapped(grads, state, params, c):
            p, s, n = update(grads, state, params, c)
            return p, s, {"norm": n, "grads": grads}
        return wrapped

    monkeypatch.setattr(jax_steps, "adamw_update",
                        record(jax_optim.adamw_update))
    jocfg = jax_optim.AdamWConfig(bits8=bits8)
    p0 = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, jcfg, jocfg, micro))
    _, _, jmet = jstep(p0, jax_optim.adamw_init(p0, jocfg),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax.tree.map(np.asarray, jmet["grad_norm"]["grads"])

    seen = {}

    def port_update(grads, state, params, c):
        seen.update({k: v.clone() for k, v in grads.items()})
        return optim.adamw_update(grads, state, params, c)

    monkeypatch.setattr(steps, "adamw_update", port_update)
    ocfg = optim.AdamWConfig(bits8=bits8)
    state = optim.adamw_init(dict(model.named_parameters()), ocfg)
    _, met = steps.make_train_step(model, cfg, ocfg, micro)(state, batch)

    assert _rel(met["loss"], jmet["loss"]) <= 1e-5
    assert _rel(met["grad_norm"], jmet["grad_norm"]["norm"]) <= 1e-5
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= 1e-5 * max(
        1.0, abs(float(jmet["aux"])))
    bf16_acc = bits8 and micro > 1
    assert {g.dtype for g in seen.values()} == {
        torch.bfloat16 if bf16_acc else torch.float32}
    grads = _stacked(tree, seen)
    for (path, g), want in zip(jax.tree_util.tree_leaves_with_path(grads),
                               jax.tree.leaves(jgrads)):
        assert _rel(g, want) <= (1e-2 if bf16_acc else 1e-5), path
    want, _, _ = jax_optim.adamw_update(
        jax.tree.map(jnp.asarray, grads),
        jax_optim.adamw_init(p0, jocfg), p0, jocfg)
    want = jax.tree.map(np.asarray, want)
    for name, p in model.named_parameters():
        assert _rel(_np(p), _ref_leaf(want, name)) <= 1e-6, name
