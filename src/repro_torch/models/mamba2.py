"""Mamba2 (SSD, arXiv:2405.21060) — the counterpart of
``repro.models.mamba2.Mamba2LM`` for ``family="ssm"``, the forward without
a cache (the reference's training / scoring path).

The parameters mirror the reference's tree: ``embed`` (V_pad, d), one
block per layer (``norm``, the projections ``wz``/``wx`` (d, d_inner),
``wB``/``wC`` (d, N), ``wdt`` (d, H), the causal conv ``conv_w``
(k, d_inner + 2N) and ``conv_b``, ``A_log``, ``D``, ``dt_bias`` (H,) in
float32, ``gate_norm`` (d_inner,) and ``out_proj`` (d_inner, d)),
``final_norm`` and ``head`` (d, V_pad).  The layer stack runs as a Python
loop; the reference's ``scan``, remat and cotangent cast serve training
and have no counterpart here.  The SSD scan runs K6 and every RMSNorm K7,
through :mod:`repro_torch.kernels.dispatch`.

The reference's numerics are kept op for op, including its type
promotions:

* the z / x / B / C projections cast the weights to the activation dtype
  and return it;
* the ``dt`` projection multiplies the (bf16) activations with the float32
  ``wdt``: JAX promotes that einsum to float32, so ``wdt`` is never cast
  down;
* the causal conv multiplies the (bf16) inputs with the float32 ``conv_w``
  tap by tap, from tap 0, and adds the float32 ``conv_b``: float32, then
  silu in float32 and a cast to the activation dtype;
* ``dt = softplus(dt_raw + dt_bias)`` and ``A = −exp(A_log)`` in float32;
* the gate ``y·silu(z)`` is a product in the activation dtype, then the
  gate norm;
* the head multiplies the final-normed activations with the float32 head
  in float32 and keeps every padded vocabulary column.

Prefill and decode (``SSMCache``, ``ssd_decode_step``, the conv ring
buffer) come with the LM-serving slice (ROADMAP A13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import (apply_norm, dense, embed_lookup,
                                       rms_norm)

__all__ = ["Mamba2LM", "mamba_block", "causal_conv"]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, di, N, H, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_conv)
        pd, f32 = cfg.pdtype, torch.float32
        self.norm = (_param((d,), pd, device)
                     if cfg.norm_type == "rmsnorm" else None)
        self.wz = _param((d, di), pd, device)
        self.wx = _param((d, di), pd, device)
        self.wB = _param((d, N), pd, device)
        self.wC = _param((d, N), pd, device)
        self.wdt = _param((d, H), pd, device)
        self.conv_w = _param((k, di + 2 * N), pd, device)
        self.conv_b = _param((di + 2 * N,), pd, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.gate_norm = _param((di,), pd, device)
        self.out_proj = _param((di, d), pd, device)


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv without a cache: u (B, L, Dc), w (k, Dc),
    b (Dc,) → (B, L, Dc) in the promoted dtype (float32 for bf16 inputs
    and float32 weights), summed tap by tap from tap 0 as the reference."""
    k, L = w.shape[0], u.shape[1]
    hist = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                       device=u.device)
    full = torch.cat([hist, u], dim=1)                  # (B, L+k−1, Dc)
    y = full[:, 0:L] * w[0]
    for i in range(1, k):
        y = y + full[:, i:i + L] * w[i]
    return y + b


def mamba_block(blk: _Block, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm residual Mamba2 block without a cache: x (b, L, d) →
    (b, L, d) in x's dtype."""
    b, L, _ = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = apply_norm(cfg.norm_type, x, blk.norm)
    z = dense(blk.wz, h)
    xin = dense(blk.wx, h)
    Bin = dense(blk.wB, h)
    Cin = dense(blk.wC, h)
    pt = torch.promote_types(h.dtype, blk.wdt.dtype)     # JAX's promotion
    dt_raw = torch.matmul(h.to(pt), blk.wdt.to(pt)).float()
    conv = causal_conv(torch.cat([xin, Bin, Cin], dim=-1), blk.conv_w,
                       blk.conv_b)
    conv = F.silu(conv.float()).to(x.dtype)
    xs = conv[..., :di].reshape(b, L, H, Pd)             # views of conv
    Bs = conv[..., di:di + N]
    Cs = conv[..., di + N:]
    dt = F.softplus(dt_raw + blk.dt_bias)
    A = -torch.exp(blk.A_log)
    y = dispatch.ssd_scan(xs, Bs, Cs, dt, A, blk.D, cfg.ssm_chunk)
    y = y.reshape(b, L, di) * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, blk.gate_norm)
    return x + dense(blk.out_proj, y)


class Mamba2LM(nn.Module):
    """``Mamba2LM(cfg, device)``; ``device=None`` means the card (raises
    without CUDA).  Parameters are allocated uninitialised: fill them with
    :meth:`init_params` or load them (``repro_torch.convert``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "ssm" or cfg.moe_experts:
            raise NotImplementedError(
                f"Mamba2LM runs the ssm family; got family {cfg.family!r}, "
                f"{cfg.moe_experts} experts (ROADMAP A13)")
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        dev, d, vp = self.device, cfg.d_model, cfg.vocab_padded
        self.embed = _param((vp, d), cfg.pdtype, dev)
        self.blocks = nn.ModuleList(_Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = (_param((d,), cfg.pdtype, dev)
                           if cfg.norm_type == "rmsnorm" else None)
        self.head = _param((d, vp), cfg.pdtype, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Mamba2LM":
        """Random weights at the reference's scales (normal × fan_in^-½,
        conv × k^-½, zero conv bias, A_log = log(linspace(1, 16, H)),
        D = 1, dt_bias = −2, norm weights 1) drawn from ``generator``,
        which lives on the model's device.  Same seed, same weights; not
        the reference's numbers (``jax.random`` differs)."""
        cfg = self.cfg

        def normal(p: torch.Tensor, scale: float) -> None:
            p.normal_(generator=generator).mul_(scale)

        normal(self.embed, cfg.d_model ** -0.5)
        H = cfg.ssm_heads
        for blk in self.blocks:
            for p in (blk.wz, blk.wx, blk.wB, blk.wC, blk.wdt):
                normal(p, cfg.d_model ** -0.5)
            normal(blk.conv_w, cfg.ssm_conv ** -0.5)
            normal(blk.out_proj, cfg.d_inner ** -0.5)
            blk.conv_b.zero_()
            blk.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
            blk.D.fill_(1.0)
            blk.dt_bias.fill_(-2.0)
            blk.gate_norm.fill_(1.0)
            if blk.norm is not None:
                blk.norm.fill_(1.0)
        if self.final_norm is not None:
            self.final_norm.fill_(1.0)
        normal(self.head, cfg.d_model ** -0.5)
        return self

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V_pad) float32: the final norm, then both
        operands in float32 (exact for bf16), the reference's promoted
        einsum."""
        x = apply_norm(self.cfg.norm_type, x, self.final_norm)
        return torch.matmul(x.float(), self.head.float())

    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` (B, S) ints → (logits (B, S, V_pad) float32,
        aux loss 0.0) over the full sequence."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_lookup(self.embed, tokens, self.cfg.adtype)
        for blk in self.blocks:
            x = mamba_block(blk, x, self.cfg)
        return self.logits(x), torch.zeros((), device=self.device)
