"""Serve steps — the serving half of ``repro.train.steps``.

``make_prefill_step`` / ``make_decode_step`` are the reference's serving
roots: prefill writes the cache and returns the last position's logits
(its batch carries the VLM's ``image_embeds`` or the audio model's
``audio_frames`` through to the model);
decode takes one token per row and picks the next greedily over the TRUE
vocabulary (the tables are padded to a multiple of 256).  There is no jit
and no donation: the model writes its cache in place.  The training steps
(loss, AdamW, gradient accumulation) come with ROADMAP A13c.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step"]


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
