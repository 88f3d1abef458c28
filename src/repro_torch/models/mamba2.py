"""Mamba2 (SSD, arXiv:2405.21060) — the counterpart of
``repro.models.mamba2.Mamba2LM`` for ``family="ssm"``: the forward over a
full sequence, and the serving path with an :class:`SSMCache`.

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

Serving follows the reference too.  The cache holds per layer the SSM
state (B, H, N, P) in float32 and the last k−1 conv inputs (B, k−1, Dc) in
the activation dtype.  Prefill runs the chunked scan through K6, which
writes the state after the last token straight into the cache; like the
reference's ``ssd_chunked``, it starts from a zero state whatever the
cache holds (only the conv history is read).  Decode is the O(1)
recurrence :func:`ssd_decode_step`, plain tensor code as in the reference
(no kernel there).  Prefill and decode update each layer's state and conv
history in the cache in place and return the cache.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import (apply_norm, dense, embed_lookup,
                                       rms_norm)

__all__ = ["Mamba2LM", "SSMCache", "mamba_block", "causal_conv",
           "ssd_decode_step"]


@dataclasses.dataclass
class SSMCache:
    """state: (B, H, N, P) float32; conv: (B, k−1, Dc) recent conv inputs
    (the model stacks a layer axis in front of both)."""

    state: torch.Tensor
    conv: torch.Tensor


def ssd_decode_step(x, B, C, dt, A, D, state):
    """One-token recurrence: x (b, 1, H, P); B, C (b, 1, N); dt (b, 1, H);
    A, D (H,); state (b, H, N, P) float32, updated in place → y (b, 1, H,
    P) in x's dtype: S ← exp(A·dt)·S + dt·B⊗x, y = C·S + D·x (the
    reference's ops in its order)."""
    dtA = torch.exp(dt[:, 0] * A[None, :])                 # (b, H)
    S = state.mul_(dtA[..., None, None]).add_(torch.einsum(
        "bN,bh,bhp->bhNp", B[:, 0].float(), dt[:, 0], x[:, 0].float()))
    y = torch.einsum("bN,bhNp->bhp", C[:, 0].float(), S) \
        + D[None, :, None] * x[:, 0].float()
    return y[:, None].to(x.dtype)


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


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_cache: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv: u (B, L, Dc), w (k, Dc), b (Dc,) → y (B, L,
    Dc) in the promoted dtype (float32 for bf16 inputs and float32
    weights), summed tap by tap from tap 0 as the reference.  The history
    before u is ``conv_cache`` (B, k−1, Dc) or zeros; a ``conv_cache`` is
    then overwritten in place with the last k−1 rows of history + u."""
    k, L = w.shape[0], u.shape[1]
    if conv_cache is None:
        hist = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    else:
        hist = conv_cache.to(u.dtype)
    full = torch.cat([hist, u], dim=1)                  # (B, L+k−1, Dc)
    y = full[:, 0:L] * w[0]
    for i in range(1, k):
        y = y + full[:, i:i + L] * w[i]
    if conv_cache is not None and k > 1:
        conv_cache.copy_(full[:, -(k - 1):])
    return y + b


def mamba_block(blk: _Block, x: torch.Tensor, cfg: ModelConfig,
                cache: SSMCache | None = None,
                decode: bool = False) -> torch.Tensor:
    """Pre-norm residual Mamba2 block: x (b, L, d) → x + out in x's dtype.
    With a cache (one layer's), it is updated in place: the conv continues
    its history, and the scan (K6) writes its final state into
    ``cache.state`` (prefill) or ``decode`` runs the one-token recurrence
    on it."""
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
                       blk.conv_b, None if cache is None else cache.conv)
    conv = F.silu(conv.float()).to(x.dtype)
    xs = conv[..., :di].reshape(b, L, H, Pd)             # views of conv
    Bs = conv[..., di:di + N]
    Cs = conv[..., di + N:]
    dt = F.softplus(dt_raw + blk.dt_bias)
    A = -torch.exp(blk.A_log)
    if decode:
        y = ssd_decode_step(xs, Bs, Cs, dt, A, blk.D, cache.state)
    elif cache is not None:
        y, _ = dispatch.ssd_scan(xs, Bs, Cs, dt, A, blk.D, cfg.ssm_chunk,
                                 state_out=cache.state)
    else:
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
                f"{cfg.moe_experts} experts (ROADMAP A13b)")
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
        x = self._embed(batch["tokens"])
        for blk in self.blocks:
            x = mamba_block(blk, x, self.cfg)
        return self.logits(x), torch.zeros((), device=self.device)

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        return embed_lookup(self.embed, tokens, self.cfg.adtype)

    # ------------------------------------------------------------- cache --
    def init_cache(self, batch_size: int, max_seq: int) -> SSMCache:
        """A zeroed cache: state (L, B, H, N, P) float32 and conv
        (L, B, k−1, d_inner + 2N) in the activation dtype.  ``max_seq`` is
        unused: the state's size does not grow with the context."""
        cfg = self.cfg
        L, dev = cfg.n_layers, self.device
        return SSMCache(
            torch.zeros((L, batch_size, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_head_dim), dtype=torch.float32, device=dev),
            torch.zeros((L, batch_size, cfg.ssm_conv - 1,
                         cfg.d_inner + 2 * cfg.ssm_state), dtype=cfg.adtype,
                        device=dev))

    def _run_cached(self, x: torch.Tensor, cache: SSMCache,
                    decode: bool) -> torch.Tensor:
        for li, blk in enumerate(self.blocks):
            x = mamba_block(blk, x, self.cfg,
                            SSMCache(cache.state[li], cache.conv[li]),
                            decode=decode)
        return x

    def prefill(self, batch, cache: SSMCache):
        """Full-prompt pass writing the cache; returns (the last position's
        logits (B, 1, V_pad) float32, cache)."""
        x = self._run_cached(self._embed(batch["tokens"]), cache, False)
        # contiguous: K7 takes whole rows in order
        return self.logits(x[:, -1:, :].contiguous()), cache

    def decode_step(self, cache: SSMCache, pos: int, tokens):
        """tokens (B, 1) → (logits (B, 1, V_pad) float32, cache); ``pos``
        is unused (the recurrence carries no position)."""
        x = self._run_cached(self._embed(tokens), cache, True)
        return self.logits(x), cache
