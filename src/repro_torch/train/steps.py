"""Train and serve steps — the counterpart of ``repro.train.steps``.

``make_train_step``: cross-entropy loss (+ the MoE aux loss) → gradients →
AdamW, with optional microbatch gradient accumulation: each microbatch's
gradient is scaled by 1/n and added to an accumulator, float32 except for
8-bit AdamW (the bf16-parameter configs), which accumulates in bf16, as
the reference.  The parameters are the model's own: the step turns them
to ``requires_grad=True``, takes the gradient with ``torch.autograd.grad``
(nothing is left in ``.grad``) and updates them in place.  The reference's
jit, ``lax.scan`` over microbatches and buffer donation have no
counterpart: the microbatches run as a Python loop.

Training takes ``attention_impl="reference"``, as the reference must (its
own gradient through the Pallas flash kernel fails): K5 has no backward
(ROADMAP B2 decided against one), so a "pallas" config is refused here.
K6 and K7 train through their backward kernels on the card.

``make_prefill_step`` / ``make_decode_step`` are the serving roots:
prefill writes the cache and returns the last position's logits (its batch
carries the VLM's ``image_embeds`` or the audio model's ``audio_frames``
through to the model); decode takes one token per row and picks the next
greedily over the TRUE vocabulary (the tables are padded to a multiple of
256).  The model writes its cache in place.

The same steps are the sharded steps of the mesh planner: called under an
ambient mesh (``repro_torch.launch.mesh.use_mesh``) on a model whose
parameters are DTensors (``repro_torch.launch.shardings.shard_model``),
they take the batch's plain tensors — the same global batch on every
device — to the "batch" rule's layout (each device keeps its rows; with
``microbatches`` each microbatch is split over the batch axes, as the
reference's microbatches are; a batch already laid out is gathered
first), reduce each gradient to its parameter's
layout (the reference's gradient reduce-scatter), accumulate into
DTensors in the parameters' layout, and hand back plain metrics.  The MoE
aux loss enters the loss as ``MOE_AUX_COEF · aux`` on every device alike:
the model hands it back replicated, each device's groups summed and the
sums reduced over the batch axes (``repro_torch.models.moe``), the
reference's mean over every group.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.sharding import active_mesh, distribute, plain, shard
from repro_torch.train.optim import AdamWConfig, adamw_update

__all__ = ["MOE_AUX_COEF", "require_trainable", "make_loss_fn",
           "make_grad_fn", "make_train_step", "make_prefill_step",
           "make_decode_step"]

MOE_AUX_COEF = 0.01


def require_trainable(cfg: ModelConfig) -> None:
    """Raise ValueError unless ``cfg`` trains on the reference attention."""
    if cfg.attention_impl != "reference":
        raise ValueError(
            f"training takes attention_impl='reference', got "
            f"{cfg.attention_impl!r}: K5 has no backward (ROADMAP B2, decided "
            f"against), and "
            f"the reference cannot differentiate its own Pallas flash "
            f"kernel either")


def make_loss_fn(model, cfg: ModelConfig):
    """batch → (loss + MOE_AUX_COEF·aux, (loss, aux)); ``batch`` holds
    ``tokens``, ``labels``, optionally ``loss_mask`` and the model's
    extras, on the model's device."""
    def loss_fn(batch):
        logits, aux = model(batch)
        loss = cross_entropy_loss(logits, batch["labels"],
                                  batch.get("loss_mask"))
        return loss + MOE_AUX_COEF * aux, (loss, aux)

    return loss_fn


def make_grad_fn(model, cfg: ModelConfig):
    """batch → (loss, aux, gradients keyed like ``named_parameters()``)
    of :func:`make_loss_fn`, the parameters turned to
    ``requires_grad=True``; a parameter the loss does not reach gets
    zeros, as ``jax.grad`` gives."""
    require_trainable(cfg)
    loss_fn = make_loss_fn(model, cfg)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def grad_fn(batch):
        total, (loss, aux) = loss_fn(_rows(batch))
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), aux.detach(), {
            n: torch.zeros_like(p) if g is None else _like(g, p)
            for (n, p), g in zip(params.items(), grads)}

    return grad_fn


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient reduced to its parameter's layout."""
    pl = getattr(p, "placements", None)
    if pl is None or tuple(g.placements) == tuple(pl):
        return g
    return g.redistribute(p.device_mesh, pl)


def _on(batch: dict, device: torch.device) -> dict:
    return {k: v if hasattr(v, "placements")
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


def _rows(batch: dict) -> dict:
    """Under a mesh, each array laid out by the "batch" rule on its first
    dim (a plain one split with no communication); else as it is."""
    mesh = active_mesh()
    if mesh is None:
        return batch
    from repro_torch.models.sharding import logical_spec
    out = {}
    for k, v in batch.items():
        spec = logical_spec("batch", *([None] * (v.dim() - 1)))
        out[k] = shard(v, "batch", *([None] * (v.dim() - 1))) \
            if hasattr(v, "placements") else distribute(v, spec, mesh)
    return out


def make_train_step(model, cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """(opt_state, batch) → (opt_state, metrics {"loss", "aux",
    "grad_norm"}), the model's parameters updated in place.  ``batch``'s
    arrays go to the model's device; with ``microbatches`` > 1 its leading
    axis is split into that many equal parts."""
    grad_fn = make_grad_fn(model, cfg)
    params = dict(model.named_parameters())
    acc_dtype = torch.bfloat16 if opt_cfg.bits8 else torch.float32

    def train_step(opt_state, batch):
        batch = _on(batch, model.device)
        if microbatches <= 1:
            loss, aux, grads = grad_fn(batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            inv = 1.0 / microbatches
            grads = {n: torch.zeros_like(
                         p, dtype=acc_dtype,
                         memory_format=torch.contiguous_format)
                     for n, p in params.items()}
            loss = torch.zeros((), device=model.device)
            aux = torch.zeros((), device=model.device)
            # a laid-out batch is gathered whole: microbatch i is the
            # reference's rows i·b/n .. (i+1)·b/n, split over the batch axes
            batch = {k: plain(v) for k, v in batch.items()}
            for i in range(microbatches):
                part = {k: v.reshape(microbatches, b // microbatches,
                                     *v.shape[1:])[i]
                        for k, v in batch.items()}
                l, a, g = grad_fn(part)
                for n, acc in grads.items():
                    acc.add_((g[n] * inv).to(acc_dtype))
                loss, aux = loss + l, aux + a
                del g
            loss, aux = loss / microbatches, aux / microbatches
        _, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return opt_state, {"loss": plain(loss), "aux": plain(aux),
                           "grad_norm": plain(gnorm)}

    return train_step


def make_prefill_step(model, cfg: ModelConfig):
    def prefill_step(batch, cache):
        return model.prefill(_rows(_on(batch, model.device)), cache)

    return prefill_step


def make_decode_step(model, cfg: ModelConfig):
    def decode_step(cache, pos: int, tokens: torch.Tensor):
        tokens = _rows(_on({"tokens": tokens}, model.device))["tokens"]
        logits, cache = model.decode_step(cache, pos, tokens)
        last = plain(logits[:, -1, :])     # the whole row on every device
        next_tok = torch.argmax(last[:, :cfg.vocab], dim=-1)
        return next_tok.to(torch.int32)[:, None], logits, cache

    return decode_step
