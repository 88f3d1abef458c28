"""Whisper-large-v3-style encoder–decoder backbone (arXiv:2212.04356) — the
counterpart of ``repro.models.whisper.EncDecLM``.

The conv / mel frontend is a stub, as in the reference:
``batch["audio_frames"]`` carries precomputed (B, n_audio_frames, d) frame
embeddings.  The encoder is bidirectional self-attention with rotary and
GELU (tanh form) MLPs, then ``enc_norm``; each decoder layer runs causal
self-attention (``ln1``), cross-attention to the encoder output
(``ln_x``, no rotary) and the MLP (``ln2``).  The encoder and every
cross-attention take the chunked reference attention whatever
``attention_impl`` says (the reference hard-codes it); the decoder's
self-attention takes K5 in ``forward`` with ``attention_impl="pallas"``.

Serving: :class:`EncDecCache` holds the decoder's self-attention caches
and, per decoder layer, the encoder's keys and values.  The prefill
encodes the audio once, computes those keys and values as the reference
does — the bf16 encoder output times the float32 weights, promoted to
float32, then cast to the activation dtype — and its own decoder pass
reads them from the cache, as every decode step does.  ``forward``
instead projects the encoder output through ``dense`` (bf16 products), as
the reference.

Training: each encoder layer and each decoder layer runs under
``remat_wrap`` per ``cfg.remat`` (``forward``; the prefill's decoder
layers too, a decode step's not, as the reference), and ``forward`` casts
the gradient back to the activation dtype before the head.

Sharding: :meth:`EncDecLM.param_specs` and :meth:`EncDecLM.cache_specs`
are the reference's (``whisper.py:92``, ``:189``) keyed like
``named_parameters()``, a per-layer spec without its stacked layer entry.
Under an ambient mesh each encoder and decoder layer gathers its weights
to their tensor-parallel specs, and the activations are constrained at
the reference's sites (the frames entering the encoder, each encoder and
decoder layer's output, the embedded tokens, the vocab-parallel logits);
the prefill writes each device's shard of the cross keys and values.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import (KVCache, apply_norm, attention,
                                       attn_specs, cotangent_cast, lm_embed,
                                       lm_logits, mlp)
from repro_torch.models.sharding import (P, block_weights, param_spec, shard,
                                         subtree, write_into)
from repro_torch.models.transformer import _param, remat_wrap
from repro_torch.models.vlm import promoted_kv

__all__ = ["EncDecLM", "EncDecCache"]


@dataclasses.dataclass
class EncDecCache:
    self_attn: KVCache  # (L, B, S_max, K·hd) decoder self-attention
    cross: KVCache      # (L, B, n_frames, K·hd) the encoder's keys/values


def _attn(cfg: ModelConfig, device) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.hd
    return nn.ParameterDict({n: _param(s, cfg, device) for n, s in (
        ("wq", (d, cfg.n_heads * hd)), ("wk", (d, cfg.n_kv_heads * hd)),
        ("wv", (d, cfg.n_kv_heads * hd)), ("wo", (cfg.n_heads * hd, d)))})


def _norm(cfg: ModelConfig, device):
    return _param((cfg.d_model,), cfg, device) \
        if cfg.norm_type == "rmsnorm" else None


def _gelu_mlp(cfg: ModelConfig, device) -> nn.ParameterDict:
    d, f = cfg.d_model, cfg.d_ff
    return nn.ParameterDict({"wi": _param((d, f), cfg, device),
                             "wo": _param((f, d), cfg, device)})


class _EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1, self.attn = _norm(cfg, device), _attn(cfg, device)
        self.ln2, self.mlp = _norm(cfg, device), _gelu_mlp(cfg, device)


class _DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1, self.self_attn = _norm(cfg, device), _attn(cfg, device)
        self.ln_x, self.cross_attn = _norm(cfg, device), _attn(cfg, device)
        self.ln2, self.mlp = _norm(cfg, device), _gelu_mlp(cfg, device)


class EncDecLM(nn.Module):
    """``EncDecLM(cfg, device)``; ``device=None`` means the card (raises
    without CUDA).  Parameters, as the reference's tree: ``embed``,
    ``encoder`` (one block per encoder layer), ``decoder`` (one per
    layer), ``enc_norm``, ``final_norm``, ``head``; allocated
    uninitialised.  Raises ValueError unless ``encoder_layers`` and
    ``n_audio_frames`` are positive (the reference asserts both)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.encoder_layers <= 0 or cfg.n_audio_frames <= 0:
            raise ValueError(f"an encoder-decoder needs encoder_layers and "
                             f"n_audio_frames > 0, got {cfg.encoder_layers},"
                             f" {cfg.n_audio_frames}")
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        dev, d, vp = self.device, cfg.d_model, cfg.vocab_padded
        self.embed = _param((vp, d), cfg, dev)
        self.encoder = nn.ModuleList(_EncBlock(cfg, dev)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(_DecBlock(cfg, dev)
                                     for _ in range(cfg.n_layers))
        self.enc_norm = _norm(cfg, dev)
        self.final_norm = _norm(cfg, dev)
        self.head = _param((d, vp), cfg, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights at the reference's scales (normal × fan_in^-½,
        norm weights 1) drawn in place from ``generator``, which lives on
        the model's device; not the reference's numbers."""
        def normal(p: torch.Tensor, fan_in: int) -> None:
            p.normal_(generator=generator).mul_(fan_in ** -0.5)

        normal(self.embed, self.cfg.d_model)
        for blk in (*self.encoder, *self.decoder):
            for name, p in blk.named_parameters():
                if name.startswith("ln"):
                    p.fill_(1.0)
                else:
                    normal(p, p.shape[0])
        for p in (self.enc_norm, self.final_norm):
            if p is not None:
                p.fill_(1.0)
        normal(self.head, self.cfg.d_model)
        return self

    # ------------------------------------------------------------- specs --
    def _block_specs(self, kind: str) -> dict[str, P]:
        """An encoder ("enc") or decoder ("dec") layer's specs, keyed like
        its ``named_parameters()``."""
        attn = attn_specs()
        sites = ("attn",) if kind == "enc" else ("self_attn", "cross_attn")
        norms = ("ln1", "ln2") if kind == "enc" else ("ln1", "ln_x", "ln2")
        s = {f"{site}.{k}": v for site in sites for k, v in attn.items()}
        if self.cfg.norm_type == "rmsnorm":
            s.update({n: param_spec((None,)) for n in norms})
        s["mlp.wi"] = param_spec((None, "ff"))
        s["mlp.wo"] = param_spec(("ff", None))
        return s

    def param_specs(self) -> dict[str, P]:
        """The reference's ``param_specs()`` keyed like
        ``named_parameters()``."""
        out = {"embed": param_spec(("vocab", None))}
        for kind, blocks in (("enc", "encoder"), ("dec", "decoder")):
            spec = self._block_specs(kind)
            for i in range(len(getattr(self, blocks))):
                out.update({f"{blocks}.{i}.{k}": v for k, v in spec.items()})
        for name in ("enc_norm", "final_norm"):
            if getattr(self, name) is not None:
                out[name] = param_spec((None,))
        out["head"] = param_spec((None, "vocab"))
        return out

    def cache_specs(self) -> EncDecCache:
        spec = param_spec((None, "batch", None, "kv_heads"))
        return EncDecCache(KVCache(spec, spec), KVCache(spec, spec))

    # ------------------------------------------------------------ pieces --
    def encode(self, audio_frames) -> torch.Tensor:
        """(B, n_frames, d) frame embeddings → the normed encoder output in
        the activation dtype."""
        cfg = self.cfg
        if not hasattr(audio_frames, "placements"):
            audio_frames = torch.as_tensor(audio_frames, device=self.device)
        x = shard(audio_frames.to(cfg.adtype), "batch", "seq", None)
        layer = remat_wrap(self._enc_block, cfg.remat)
        for blk in self.encoder:
            x = layer(blk, x)
        return apply_norm(cfg.norm_type, x, self.enc_norm)

    def _enc_block(self, blk: _EncBlock, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = block_weights(blk, self._block_specs("enc"))
        h = apply_norm(cfg.norm_type, x, w.get("ln1"))
        x = x + attention(subtree(w, "attn."), h, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          rope_theta=cfg.rope_theta, causal=False,
                          impl="reference", chunk=cfg.attn_chunk)
        h = apply_norm(cfg.norm_type, x, w.get("ln2"))
        return shard(x + mlp(subtree(w, "mlp."), h, "gelu"), "batch", "seq",
                     None)

    def _dec_block(self, blk: _DecBlock, x: torch.Tensor,
                   enc_out: torch.Tensor | None = None,
                   self_cache: KVCache | None = None,
                   cache_pos: int | None = None,
                   cross_cache: KVCache | None = None) -> torch.Tensor:
        cfg = self.cfg
        w = block_weights(blk, self._block_specs("dec"))
        kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.hd, chunk=cfg.attn_chunk)
        h = apply_norm(cfg.norm_type, x, w.get("ln1"))
        x = x + attention(subtree(w, "self_attn."), h,
                          rope_theta=cfg.rope_theta, causal=True,
                          cache=self_cache, cache_pos=cache_pos,
                          impl=cfg.attention_impl, **kw)
        h = apply_norm(cfg.norm_type, x, w.get("ln_x"))
        x = x + attention(subtree(w, "cross_attn."), h, rope_theta=None,
                          causal=False, cache=cross_cache, cache_pos=None,
                          kv_source=enc_out, impl="reference", **kw)
        h = apply_norm(cfg.norm_type, x, w.get("ln2"))
        return shard(x + mlp(subtree(w, "mlp."), h, "gelu"), "batch", "seq",
                     None)

    def _embed(self, tokens) -> torch.Tensor:
        return lm_embed(self.embed, tokens, self.cfg.adtype, self.device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V_pad) float32: the final norm, then both
        operands in float32, the reference's promoted einsum;
        vocab-parallel under a mesh."""
        return lm_logits(self.cfg.norm_type, x, self.final_norm, self.head)

    def _decode(self, x: torch.Tensor, cache: EncDecCache,
                pos: int) -> torch.Tensor:
        # the reference remats the prefill's body, not decode's
        block = self._dec_block if x.shape[1] == 1 else \
            remat_wrap(self._dec_block, self.cfg.remat)
        for li, blk in enumerate(self.decoder):
            x = block(
                blk, x, None, KVCache(cache.self_attn.k[li],
                                      cache.self_attn.v[li]), pos,
                KVCache(cache.cross.k[li], cache.cross.v[li]))
        return x

    # -------------------------------------------------------------- API ---
    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch`` with ``tokens`` (B, S) and ``audio_frames`` (B,
        n_frames, d) → (logits (B, S, V_pad) float32, aux loss 0.0)."""
        enc_out = self.encode(batch["audio_frames"])
        x = self._embed(batch["tokens"])
        block = remat_wrap(self._dec_block, self.cfg.remat)
        for blk in self.decoder:
            x = block(blk, x, enc_out)
        x = cotangent_cast(x)   # keep the backward at activation dtype
        return self.logits(x), torch.zeros((), device=self.device)

    def init_cache(self, batch_size: int, max_seq: int) -> EncDecCache:
        """A zeroed cache in the activation dtype: self_attn k and v (L, B,
        max_seq, K·hd), cross k and v (L, B, n_audio_frames, K·hd)."""
        cfg = self.cfg
        kvd = cfg.n_kv_heads * cfg.hd

        def zeros(*shape):
            return torch.zeros(shape, dtype=cfg.adtype, device=self.device)

        L = cfg.n_layers
        return EncDecCache(
            KVCache(zeros(L, batch_size, max_seq, kvd),
                    zeros(L, batch_size, max_seq, kvd)),
            KVCache(zeros(L, batch_size, cfg.n_audio_frames, kvd),
                    zeros(L, batch_size, cfg.n_audio_frames, kvd)))

    def prefill(self, batch, cache: EncDecCache):
        """Encode the audio, write every layer's cross keys and values and
        the decoder's self-attention cache from position 0; returns (the
        last position's logits (B, 1, V_pad) float32, cache)."""
        enc_out = self.encode(batch["audio_frames"])
        ad = self.cfg.adtype
        specs = self._block_specs("dec")
        for li, blk in enumerate(self.decoder):
            w = block_weights(blk, specs)
            write_into(cache.cross.k[li],
                       promoted_kv(enc_out, w["cross_attn.wk"], ad))
            write_into(cache.cross.v[li],
                       promoted_kv(enc_out, w["cross_attn.wv"], ad))
        x = self._decode(self._embed(batch["tokens"]), cache, 0)
        # contiguous: K7 takes whole rows in order
        return self.logits(x[:, -1:, :].contiguous()), cache

    def decode_step(self, cache: EncDecCache, pos: int, tokens):
        """tokens (B, 1) at position ``pos`` → (logits (B, 1, V_pad)
        float32, cache)."""
        x = self._decode(self._embed(tokens), cache, int(pos))
        return self.logits(x), cache
