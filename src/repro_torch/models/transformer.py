"""Dense decoder-only LM (OLMo-style) — the counterpart of
``repro.models.transformer.DecoderLM`` for ``family="dense"`` without
experts.

The parameters mirror the reference's tree: ``embed`` (V_pad, d), one
block per layer (``ln1`` / ``ln2`` norm weights, ``attn`` wq/wk/wv/wo flat,
``mlp``), ``final_norm`` and ``head`` (d, V_pad).  A non-parametric norm
has no parameter (the reference keeps a (0,) placeholder leaf).  The layer
stack runs as a Python loop; the reference's ``scan``, remat and cotangent
cast serve training and have no counterpart here.

Two numerics of the reference are kept on purpose:

* the head multiplies the activations (bf16 in OLMo) with the float32 head
  in float32 — JAX promotes the mixed einsum — so the head is never cast
  to the activation dtype;
* the logits keep every padded vocabulary column.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import apply_norm, attention, embed_lookup, mlp

__all__ = ["DecoderLM"]


def _param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.pdtype, device=device),
                        requires_grad=False)


class _Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        rms = cfg.norm_type == "rmsnorm"
        self.ln1 = _param((d,), cfg, device) if rms else None
        self.ln2 = _param((d,), cfg, device) if rms else None
        attn = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
                "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(hd,), k_norm=(hd,))
        self.attn = nn.ParameterDict(
            {n: _param(s, cfg, device) for n, s in attn.items()})
        mlp_shapes = ({"wi_gate": (d, cfg.d_ff), "wi_up": (d, cfg.d_ff),
                       "wo": (cfg.d_ff, d)} if cfg.mlp_kind == "swiglu"
                      else {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)})
        self.mlp = nn.ParameterDict(
            {n: _param(s, cfg, device) for n, s in mlp_shapes.items()})


class DecoderLM(nn.Module):
    """``DecoderLM(cfg, device)``; ``device=None`` means the card (raises
    without CUDA).  Parameters are allocated uninitialised: fill them with
    :meth:`init_params` or load them (``repro_torch.convert``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "dense" or cfg.moe_experts:
            raise NotImplementedError(
                f"DecoderLM runs the dense family without experts; got "
                f"family {cfg.family!r}, {cfg.moe_experts} experts "
                f"(ROADMAP A13)")
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        dev, d, vp = self.device, cfg.d_model, cfg.vocab_padded
        self.embed = _param((vp, d), cfg, dev)
        self.blocks = nn.ModuleList(_Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = (_param((d,), cfg, dev)
                           if cfg.norm_type == "rmsnorm" else None)
        self.head = _param((d, vp), cfg, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights at the reference's scales (normal × fan_in^-½,
        norm weights 1) drawn from ``generator``, which lives on the
        model's device.  Same seed, same weights; not the reference's
        numbers (``jax.random`` differs)."""
        cfg = self.cfg

        def normal(p: torch.Tensor, fan_in: int) -> None:
            p.normal_(generator=generator).mul_(fan_in ** -0.5)

        normal(self.embed, cfg.d_model)
        for blk in self.blocks:
            for name, p in blk.attn.items():
                if name in ("q_norm", "k_norm"):
                    p.fill_(1.0)
                else:
                    normal(p, p.shape[0])
            for p in blk.mlp.values():
                normal(p, p.shape[0])
            for p in (blk.ln1, blk.ln2):
                if p is not None:
                    p.fill_(1.0)
        if self.final_norm is not None:
            self.final_norm.fill_(1.0)
        normal(self.head, cfg.d_model)
        return self

    # ----------------------------------------------------------- forward --
    def _block(self, blk: _Block, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg.norm_type, x, blk.ln1)
        x = x + attention(blk.attn, h, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          rope_theta=cfg.rope_theta, causal=True,
                          impl=cfg.attention_impl, chunk=cfg.attn_chunk,
                          qk_norm=cfg.qk_norm)
        h = apply_norm(cfg.norm_type, x, blk.ln2)
        return x + mlp(blk.mlp, h, cfg.mlp_kind)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V_pad) float32.  Both operands go to float32
        (exact for bf16), which is the reference's promoted einsum."""
        x = apply_norm(self.cfg.norm_type, x, self.final_norm)
        return torch.matmul(x.float(), self.head.float())

    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` (B, S) ints → (logits (B, S, V_pad) float32,
        aux loss 0.0) over the full sequence."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_lookup(self.embed, tokens, self.cfg.adtype)
        for blk in self.blocks:
            x = self._block(blk, x)
        return self.logits(x), torch.zeros((), device=self.device)
