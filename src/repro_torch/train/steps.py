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
(ROADMAP B2), so a "pallas" config is refused here.

``make_prefill_step`` / ``make_decode_step`` are the serving roots:
prefill writes the cache and returns the last position's logits (its batch
carries the VLM's ``image_embeds`` or the audio model's ``audio_frames``
through to the model); decode takes one token per row and picks the next
greedily over the TRUE vocabulary (the tables are padded to a multiple of
256).  The model writes its cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import cross_entropy_loss
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
            f"{cfg.attention_impl!r}: K5 has no backward (ROADMAP B2), and "
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
        total, (loss, aux) = loss_fn(batch)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), aux.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}

    return grad_fn


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


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
            grads = {n: torch.zeros(p.shape, dtype=acc_dtype,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), device=model.device)
            aux = torch.zeros((), device=model.device)
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
        return opt_state, {"loss": loss, "aux": aux, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model, cfg: ModelConfig):
    def prefill_step(batch, cache):
        return model.prefill(batch, cache)

    return prefill_step


def make_decode_step(model, cfg: ModelConfig):
    def decode_step(cache, pos: int, tokens: torch.Tensor):
        logits, cache = model.decode_step(cache, pos, tokens)
        next_tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
        return next_tok.to(torch.int32)[:, None], logits, cache

    return decode_step
