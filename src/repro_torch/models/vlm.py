"""Llama-3.2-Vision-style VLM — the counterpart of
``repro.models.vlm.VisionLM``: the decoder of
:mod:`repro_torch.models.transformer` with a gated cross-attention block
to image patch embeddings before every group of ``cross_attn_every``
self-attention layers.

The vision tower is a stub, as in the reference: ``batch["image_embeds"]``
carries precomputed (B, n_image_tokens, d) patch embeddings.  With L
layers there are n_cross = ⌈L / every⌉ cross blocks; block s runs before
layers ``[s·every, min((s+1)·every, L))``, so the last group is ragged
when ``every`` does not divide L.  A cross block is a norm (``ln``),
attention from the text to the image (no rotary, not causal, the chunked
reference attention whatever ``attention_impl`` says, as the reference
hard-codes) and a tanh-gated residual whose scalar ``gate`` starts at 0.

Serving: :class:`VLMCache` holds the self-attention caches (one per
layer) and the image keys and values (one per cross block).  The prefill
attends to the image through ``dense`` (bf16 products in a bf16 model)
and caches ``image_embeds @ wk`` / ``@ wv`` computed as the reference
does: the bf16 embeddings times the float32 weights, promoted to float32,
then cast to the activation dtype.  Decode reads those, rounded
differently from the keys the prefill attended to, as in the reference.

Training: the self-attention layers run under ``remat_wrap`` per
``cfg.remat`` (in ``forward``, and in a prefill of more than one token, as
the reference; the cross blocks are not recomputed), and ``forward`` casts
the gradient back to the activation dtype before the head.

Sharding: the decoder's specs (:meth:`DecoderLM.param_specs`) plus each
cross block's, the reference's (``vlm.py:67``: the gate replicated, P()),
and :meth:`VisionLM.cache_specs`.  Under an ambient mesh a cross block
gathers its weights to their tensor-parallel specs, its output is
constrained as the reference's (``vlm.py:86``), and the prefill writes
each device's shard of the image keys and values.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import (KVCache, apply_norm, attention,
                                       attn_specs, cotangent_cast)
from repro_torch.models.sharding import (P, block_weights, param_spec, shard,
                                         subtree, write_into)
from repro_torch.models.transformer import DecoderLM, _param, remat_wrap

__all__ = ["VisionLM", "VLMCache"]


@dataclasses.dataclass
class VLMCache:
    self_attn: KVCache  # (L, B, S_max, K·hd)
    cross: KVCache      # (n_cross, B, n_img, K·hd)


def promoted_kv(src: torch.Tensor, w: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``src @ w`` at the promoted dtype of the two (bf16 @ float32 →
    float32, as JAX's ``@``), cast to ``dtype``: the reference's cached
    cross-attention keys and values."""
    ct = torch.promote_types(src.dtype, w.dtype)
    return torch.matmul(src.to(ct), w.to(ct)).to(dtype)


class _CrossBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.ln = _param((d,), cfg, device) \
            if cfg.norm_type == "rmsnorm" else None
        self.attn = nn.ParameterDict({n: _param(s, cfg, device) for n, s in (
            ("wq", (d, cfg.n_heads * hd)), ("wk", (d, cfg.n_kv_heads * hd)),
            ("wv", (d, cfg.n_kv_heads * hd)), ("wo", (cfg.n_heads * hd, d)))})
        self.gate = _param((), cfg, device)


class VisionLM(DecoderLM):
    """``VisionLM(cfg, device)``: the decoder's parameters plus ``cross``,
    one :class:`_CrossBlock` per group.  Raises ValueError unless
    ``cross_attn_every`` and ``n_image_tokens`` are positive (the
    reference asserts both)."""

    FAMILIES = ("vlm",)

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.cross_attn_every <= 0 or cfg.n_image_tokens <= 0:
            raise ValueError(f"a VLM needs cross_attn_every and "
                             f"n_image_tokens > 0, got "
                             f"{cfg.cross_attn_every}, {cfg.n_image_tokens}")
        super().__init__(cfg, device)
        self.cross = nn.ModuleList(_CrossBlock(cfg, self.device)
                                   for _ in range(self.n_cross))

    @property
    def n_cross(self) -> int:
        return -(-self.cfg.n_layers // self.cfg.cross_attn_every)

    def _group(self, s: int) -> tuple[int, int]:
        lo = s * self.cfg.cross_attn_every
        return lo, min(lo + self.cfg.cross_attn_every, self.cfg.n_layers)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "VisionLM":
        """The decoder's weights (:meth:`DecoderLM.init_params`), then per
        cross block the norm weight 1, attention × fan_in^-½ and the gate
        0, as the reference: the cross path adds nothing until a gate is
        loaded."""
        super().init_params(generator)
        for cb in self.cross:
            for p in cb.attn.values():
                p.normal_(generator=generator).mul_(p.shape[0] ** -0.5)
            if cb.ln is not None:
                cb.ln.fill_(1.0)
            cb.gate.zero_()
        return self

    # ------------------------------------------------------------- specs --
    def _cross_specs(self) -> dict[str, P]:
        """One cross block's specs, keyed like its
        ``named_parameters()``."""
        s = {"attn." + k: v for k, v in attn_specs().items()}
        if self.cfg.norm_type == "rmsnorm":
            s["ln"] = param_spec((None,))
        s["gate"] = param_spec(())
        return s

    def param_specs(self) -> dict[str, P]:
        """The reference's ``param_specs()`` (``vlm.py:67``) keyed like
        ``named_parameters()``."""
        out = super().param_specs()
        cross = self._cross_specs()
        for s in range(self.n_cross):
            out.update({f"cross.{s}.{k}": v for k, v in cross.items()})
        return out

    def cache_specs(self) -> VLMCache:
        spec = param_spec((None, "batch", None, "kv_heads"))
        return VLMCache(KVCache(spec, spec), KVCache(spec, spec))

    # ------------------------------------------------------------ pieces --
    def _cross_block(self, w: dict, x: torch.Tensor,
                     image_embeds: torch.Tensor | None = None,
                     cache: KVCache | None = None) -> torch.Tensor:
        """One cross block on its weights ``w`` (:func:`block_weights`)."""
        cfg = self.cfg
        h = apply_norm(cfg.norm_type, x, w.get("ln"))
        a = attention(subtree(w, "attn."), h, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                      rope_theta=None, causal=False, cache=cache,
                      cache_pos=None, kv_source=image_embeds,
                      impl="reference", chunk=cfg.attn_chunk)
        x = x + torch.tanh(w["gate"].float()).to(x.dtype) * a
        return shard(x, "batch", "seq", None)

    def _run(self, x: torch.Tensor, image_embeds: torch.Tensor | None = None,
             cache: VLMCache | None = None,
             cache_pos: int | None = None) -> torch.Tensor:
        """Per group: the cross block (to ``image_embeds``, or to the
        cached image keys and values when there are none), then its
        self-attention layers.  A prefill (a cache and ``image_embeds``)
        also writes the image keys and values into ``cache.cross``."""
        block = self._block if cache is not None and x.shape[1] == 1 else \
            remat_wrap(self._block, self.cfg.remat)
        specs = self._cross_specs()
        for s in range(self.n_cross):
            w = block_weights(self.cross[s], specs)
            cross = None
            if cache is not None and image_embeds is None:
                cross = KVCache(cache.cross.k[s], cache.cross.v[s])
            x = self._cross_block(w, x, image_embeds, cross)
            if cache is not None and image_embeds is not None:
                ad = self.cfg.adtype
                write_into(cache.cross.k[s],
                           promoted_kv(image_embeds, w["attn.wk"], ad))
                write_into(cache.cross.v[s],
                           promoted_kv(image_embeds, w["attn.wv"], ad))
            lo, hi = self._group(s)
            for li in range(lo, hi):
                layer = None if cache is None else \
                    KVCache(cache.self_attn.k[li], cache.self_attn.v[li])
                x, _ = block(self.blocks[li], x, layer, cache_pos)
        return x

    def _image(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["image_embeds"], device=self.device) \
            .to(self.cfg.adtype)

    # -------------------------------------------------------------- API ---
    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch`` with ``tokens`` (B, S) and ``image_embeds`` (B, n_img,
        d) → (logits (B, S, V_pad) float32, aux loss 0.0)."""
        x = self._run(self._embed(batch["tokens"]), self._image(batch))
        x = cotangent_cast(x)   # keep the backward at activation dtype
        return self.logits(x), torch.zeros((), device=self.device)

    def init_cache(self, batch_size: int, max_seq: int) -> VLMCache:
        """A zeroed cache in the activation dtype: self_attn k and v (L, B,
        max_seq, K·hd), cross k and v (n_cross, B, n_image_tokens, K·hd)."""
        cfg = self.cfg
        kvd = cfg.n_kv_heads * cfg.hd

        def zeros(*shape):
            return torch.zeros(shape, dtype=cfg.adtype, device=self.device)

        return VLMCache(
            KVCache(zeros(cfg.n_layers, batch_size, max_seq, kvd),
                    zeros(cfg.n_layers, batch_size, max_seq, kvd)),
            KVCache(zeros(self.n_cross, batch_size, cfg.n_image_tokens, kvd),
                    zeros(self.n_cross, batch_size, cfg.n_image_tokens, kvd)))

    def prefill(self, batch, cache: VLMCache):
        """Full-prompt pass with the image, writing both caches; returns
        (the last position's logits (B, 1, V_pad) float32, cache)."""
        x = self._run(self._embed(batch["tokens"]), self._image(batch),
                      cache, 0)
        # contiguous: K7 takes whole rows in order
        return self.logits(x[:, -1:, :].contiguous()), cache

    def decode_step(self, cache: VLMCache, pos: int, tokens):
        """tokens (B, 1) at position ``pos`` → (logits (B, 1, V_pad)
        float32, cache); the image keys and values are read, not
        written."""
        x = self._run(self._embed(tokens), None, cache, int(pos))
        return self.logits(x), cache
