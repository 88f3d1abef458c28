"""Mamba2 (SSD, arXiv:2405.21060) — the counterpart of
``repro.models.mamba2.Mamba2LM`` for ``family="ssm"``: the forward over a
full sequence, and the serving path with an :class:`SSMCache`.

The parameters mirror the reference's tree: ``embed`` (V_pad, d), one
block per layer (``norm``, the projections ``wz``/``wx`` (d, d_inner),
``wB``/``wC`` (d, N), ``wdt`` (d, H), the causal conv ``conv_w``
(k, d_inner + 2N) and ``conv_b``, ``A_log``, ``D``, ``dt_bias`` (H,) in
float32, ``gate_norm`` (d_inner,) and ``out_proj`` (d_inner, d)),
``final_norm`` and ``head`` (d, V_pad).  The layer stack runs as a Python
loop in place of the reference's ``scan``, each block under
``remat_wrap`` per ``cfg.remat`` (``forward`` and ``prefill``, as the
reference), and ``forward`` casts the gradient back to the activation
dtype before the head (``cotangent_cast``).  The SSD scan runs K6 and every
RMSNorm K7, through :mod:`repro_torch.kernels.dispatch`; K6 has no
backward on the card (its route raises under grad), so Mamba2 trains on
the CPU route, through the plain scan, as the reference trains through
its ``ssd_chunked``.

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

Sharding: :func:`mamba_block_specs` and :meth:`Mamba2LM.cache_specs` are
the reference's specs (``mamba_block_specs``, ``cache_specs``) keyed like
``named_parameters()``, a per-layer spec without its stacked layer entry.
Under an ambient mesh each block first gathers its weights to their
tensor-parallel specs (the ZeRO-3 gather; the conv taps and the gate norm
whole), then keeps d_inner split over ``model`` where GSPMD keeps it and
gathers it where an op needs whole rows:

* z and the x projection come out split on ``inner``, the B / C
  projections replicated; the causal conv runs on whole channels (x's
  part gathered: the conv is depthwise, and its cache slice is laid out
  on ``inner`` as the reference's, so it is gathered and written back
  shard by shard);
* xs is split on ``heads`` (the reference's ``shard`` at
  ``mamba2.py:194``), so K6 scans each device's heads, with B and C
  replicated; its output keeps the head split through the gate;
* the gate norm normalises over d_inner, and K7 takes whole rows: its
  input is gathered first, as GSPMD gathers the reduced dim, and the out
  projection splits it again against ``out_proj``'s rows.

Without a mesh all of it is a no-op.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import (_reshape, apply_norm, cotangent_cast,
                                       dense, lm_embed, lm_logits, rms_norm)
from repro_torch.models.sharding import (P, active_mesh, block_weights,
                                         gather_inner, gather_inner_grad,
                                         param_spec, shard, whole_last,
                                         write_into)
from repro_torch.models.transformer import remat_wrap

__all__ = ["Mamba2LM", "SSMCache", "mamba_block", "init_mamba_block",
           "mamba_block_specs", "causal_conv", "ssd_decode_step"]


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


@torch.no_grad()
def init_mamba_block(blk: _Block, cfg: ModelConfig,
                     generator: torch.Generator) -> None:
    """One block's random weights at the reference's scales (see
    :meth:`Mamba2LM.init_params`), drawn from ``generator``."""

    def normal(p: torch.Tensor, scale: float) -> None:
        p.normal_(generator=generator).mul_(scale)

    for p in (blk.wz, blk.wx, blk.wB, blk.wC, blk.wdt):
        normal(p, cfg.d_model ** -0.5)
    normal(blk.conv_w, cfg.ssm_conv ** -0.5)
    normal(blk.out_proj, cfg.d_inner ** -0.5)
    blk.conv_b.zero_()
    blk.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads)))
    blk.D.fill_(1.0)
    blk.dt_bias.fill_(-2.0)
    blk.gate_norm.fill_(1.0)
    if blk.norm is not None:
        blk.norm.fill_(1.0)


def mamba_block_specs(cfg: ModelConfig) -> dict[str, P]:
    """One block's specs, keyed like its ``named_parameters()``: the
    reference's ``mamba_block_specs`` (a non-parametric norm has no
    parameter here)."""
    s = {"wz": (None, "inner"), "wx": (None, "inner"), "wB": (None, None),
         "wC": (None, None), "wdt": (None, "heads"),
         "conv_w": (None, "inner"), "conv_b": ("inner",),
         "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
         "gate_norm": ("inner",), "out_proj": ("inner", None)}
    if cfg.norm_type == "rmsnorm":
        s = {"norm": (None,), **s}
    return {k: param_spec(v) for k, v in s.items()}


def _weights(blk: _Block, cfg: ModelConfig) -> dict:
    """``blk``'s weights by name; under a mesh each gathered to its
    tensor-parallel spec, the conv taps and the gate norm whole (the conv
    runs on whole channels, K7 on whole rows)."""
    if active_mesh() is None:
        return blk._parameters
    specs = mamba_block_specs(cfg)
    specs.update(conv_w=P(None, None), conv_b=P(None), gate_norm=P(None))
    return block_weights(blk, specs)


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_cache: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv: u (B, L, Dc), w (k, Dc), b (Dc,) → y (B, L,
    Dc) in the promoted dtype (float32 for bf16 inputs and float32
    weights), summed tap by tap from tap 0 as the reference.  The history
    before u is ``conv_cache`` (B, k−1, Dc) or zeros; a ``conv_cache`` is
    then overwritten in place with the last k−1 rows of history + u."""
    k, L = w.shape[0], u.shape[1]
    if conv_cache is None and hasattr(u, "placements"):
        hist = torch.zeros_like(u[:, :1]).expand(-1, k - 1, -1)  # u's layout
    elif conv_cache is None:
        hist = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    else:
        hist = whole_last(conv_cache).to(u.dtype)
    full = torch.cat([hist, u], dim=1)                  # (B, L+k−1, Dc)
    y = full[:, 0:L] * w[0]
    for i in range(1, k):
        y = y + full[:, i:i + L] * w[i]
    if conv_cache is not None and k > 1:
        write_into(conv_cache, full[:, -(k - 1):])
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
    w = _weights(blk, cfg)
    h = apply_norm(cfg.norm_type, x, w.get("norm"))
    z = dense(w["wz"], h)
    xin = dense(w["wx"], h)
    Bin = dense(w["wB"], h)
    Cin = dense(w["wC"], h)
    pt = torch.promote_types(h.dtype, w["wdt"].dtype)    # JAX's promotion
    dt_raw = gather_inner_grad(torch.matmul(
        gather_inner(h).to(pt), w["wdt"].to(pt))).float()
    # the depthwise conv on whole channels: x's split part gathered
    conv = causal_conv(torch.cat([whole_last(xin), Bin, Cin], dim=-1),
                       w["conv_w"], w["conv_b"],
                       None if cache is None else cache.conv)
    conv = F.silu(conv.float()).to(x.dtype)
    xs = _reshape(conv[..., :di], b, L, H, Pd)           # views of conv
    xs = shard(xs, "batch", None, "heads", None)
    Bs = conv[..., di:di + N]
    Cs = conv[..., di + N:]
    dt = F.softplus(dt_raw + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    if decode:
        y = ssd_decode_step(xs, Bs, Cs, dt, A, w["D"], cache.state)
    elif cache is not None:
        y, _ = dispatch.ssd_scan(xs, Bs, Cs, dt, A, w["D"], cfg.ssm_chunk,
                                 state_out=cache.state)
    else:
        y = dispatch.ssd_scan(xs, Bs, Cs, dt, A, w["D"], cfg.ssm_chunk)
    y = _reshape(y, b, L, di) * F.silu(z.float()).to(x.dtype)
    # K7 normalises whole rows of d_inner
    y = rms_norm(whole_last(y), w["gate_norm"])
    return x + dense(w["out_proj"], y)


def ssm_cache_specs() -> SSMCache:
    """The reference's ``SSMCache`` specs: the state split on rows and
    heads, the conv history on rows and ``inner``."""
    return SSMCache(param_spec((None, "batch", "heads", None, None)),
                    param_spec((None, "batch", None, "inner")))


class Mamba2LM(nn.Module):
    """``Mamba2LM(cfg, device)``; ``device=None`` means the card (raises
    without CUDA).  Parameters are allocated uninitialised: fill them with
    :meth:`init_params` or load them (``repro_torch.convert``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2LM runs the ssm family, got "
                             f"{cfg.family!r}")
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
        for blk in self.blocks:
            init_mamba_block(blk, cfg, generator)
        if self.final_norm is not None:
            self.final_norm.fill_(1.0)
        normal(self.head, cfg.d_model ** -0.5)
        return self

    # ------------------------------------------------------------- specs --
    def param_specs(self) -> dict[str, P]:
        """The reference's ``param_specs()`` keyed like
        ``named_parameters()``, each per-layer spec without its stacked
        layer entry."""
        out = {"embed": param_spec(("vocab", None))}
        block = mamba_block_specs(self.cfg)
        for i in range(self.cfg.n_layers):
            out.update({f"blocks.{i}.{k}": v for k, v in block.items()})
        if self.final_norm is not None:
            out["final_norm"] = param_spec((None,))
        out["head"] = param_spec((None, "vocab"))
        return out

    def cache_specs(self) -> SSMCache:
        return ssm_cache_specs()

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V_pad) float32: the final norm, then both
        operands in float32 (exact for bf16), the reference's promoted
        einsum; vocab-parallel under a mesh."""
        return lm_logits(self.cfg.norm_type, x, self.final_norm, self.head)

    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` (B, S) ints → (logits (B, S, V_pad) float32,
        aux loss 0.0) over the full sequence."""
        x = self._embed(batch["tokens"])
        block = remat_wrap(mamba_block, self.cfg.remat)
        for blk in self.blocks:
            x = block(blk, x, self.cfg)
        x = cotangent_cast(x)   # keep the backward at activation dtype
        return self.logits(x), torch.zeros((), device=self.device)

    def _embed(self, tokens) -> torch.Tensor:
        return lm_embed(self.embed, tokens, self.cfg.adtype, self.device)

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
        # the reference remats the prefill's body, not decode's
        block = mamba_block if decode else remat_wrap(mamba_block,
                                                      self.cfg.remat)
        for li, blk in enumerate(self.blocks):
            x = block(blk, x, self.cfg,
                      SSMCache(cache.state[li], cache.conv[li]), decode)
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
