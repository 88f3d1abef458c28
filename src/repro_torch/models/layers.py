"""Neural layers of the port — the counterpart of ``repro.models.layers``,
as plain functions on tensors.

Parameters are the reference's, in its layout: attention weights FLAT,
``(d, H·hd)``, so one parameter tree describes the same model in both
packages (``repro_torch.convert.decoder_lm_from_arrays``).  Numerics follow
the reference op for op: norms, rotary and softmax in float32; matmuls read
the weights cast to the activation dtype and return the activation dtype.

RMSNorm with a weight runs K7 (:func:`rms_norm`), qwen3's q/k-norm
included.  Attention is self-attention, with or without a
:class:`KVCache`, or cross-attention.  Causal self-attention without a
cache (the training / scoring path) takes one of two routes, chosen by
``impl``:

  * ``"pallas"`` — K5 through :mod:`repro_torch.kernels.dispatch`: the CUDA
    flash-attention kernel on the card, its plain version on the CPU;
  * ``"reference"`` — :func:`_sdpa_chunked`, query chunks with float32
    softmax rows.

Everything else takes :func:`_sdpa_chunked` whatever ``impl`` says, as
the reference does: a cache (prefill and decode), non-causal attention
(the Whisper encoder) and cross-attention (``kv_source``, or a cache read
without ``cache_pos``: the VLM and the audio decoder) — except a
one-token query with grouped kv heads, which takes the reference's
grouped einsum and never repeats the keys.  The reference's mesh
constraints (``shard``, ``shard_div``, ``constrain_tree``) are identities
on one device and have no counterpart.

Training: every layer here is differentiable on both routes (K7 through
its backward kernel on the card).  :func:`embed_lookup`'s table gradient
mirrors the reference's one-hot matmul, rounded to the activation dtype
as that product is; :func:`cotangent_cast` is the reference's guard
between the float32 head and the layer stack.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch, ref

__all__ = [
    "rms_norm", "layer_norm", "apply_norm", "dense", "embed_lookup",
    "rotary_embedding", "apply_rotary", "KVCache", "attention", "mlp",
    "cotangent_cast", "token_cross_entropy", "cross_entropy_loss",
]

ATTENTION_IMPLS = ("reference", "pallas")


# ---------------------------------------------------------------- norms ----

def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """With a weight: K7 through :mod:`repro_torch.kernels.dispatch` (the
    CUDA kernel on the card, its plain version on the CPU).  Without one
    (no caller of the port passes ``None``) the plain math on x's device."""
    if weight is None:
        return ref.rmsnorm_plain(x, None, eps)
    return dispatch.rmsnorm(x, weight, eps)


def layer_norm(x: torch.Tensor, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when weight/bias are None (OLMo-style)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def apply_norm(norm_type: str, x: torch.Tensor, w, eps: float = 1e-6):
    """As the reference: LayerNorm takes eps 1e-5 whatever ``eps`` says."""
    if norm_type == "rmsnorm":
        return rms_norm(x, w, eps)
    return layer_norm(x, eps=1e-5)


# ---------------------------------------------------------------- dense ----

def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the weight cast to the activation dtype and the result
    in the activation dtype (bf16 products accumulate in float32 inside the
    matmul, as the reference's ``preferred_element_type=x.dtype``)."""
    return torch.matmul(x, w.to(x.dtype))


# the reference's one-hot embedding runs in chunks of this many positions
# (``repro.models.layers.embed_lookup``'s ``chunk``)
EMBED_CHUNK = 512


class _EmbedLookup(torch.autograd.Function):
    """Rows of the table in the activation dtype, with the reference's
    table gradient: its one-hot matmul ``one_hot(tokens) @ table`` in the
    activation dtype (``repro.models.layers.embed_lookup``) has the
    gradient ``one_hotᵀ @ dy`` per chunk of ``EMBED_CHUNK`` positions, each
    product rounded once to that dtype, the chunks summed in it from the
    last (the order of its scan's transpose), then cast to the table's
    dtype.  Here each chunk's product is summed in float32 by
    ``embedding_dense_backward`` (deterministic on the card, unlike an
    ``index_add_``) and rounded once, as XLA's product is."""

    @staticmethod
    def forward(ctx, table, tokens, out_dtype):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.table_dtype, ctx.out_dtype = (table.shape[0],
                                                     table.dtype, out_dtype)
        return F.embedding(tokens, table).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        acc = None
        for start in reversed(range(0, max(tokens.shape[-1], 1),
                                    EMBED_CHUNK)):
            end = start + EMBED_CHUNK
            part = torch.ops.aten.embedding_dense_backward(
                g[..., start:end, :].float(), tokens[..., start:end],
                ctx.vocab, -1, False).to(ctx.out_dtype)
            acc = part if acc is None else acc + part
        return acc.to(ctx.table_dtype), None, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Rows of ``table`` in ``out_dtype``.  The reference computes a one-hot
    matmul (TPU-friendly); selecting one row per token is the same value
    exactly, and casting after the lookup equals casting the table.  Under
    grad the table's gradient is the reference's (:class:`_EmbedLookup`):
    at bf16 activations rounded to bf16, where ``F.embedding``'s own
    backward would keep float32."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, tokens, out_dtype)
    return F.embedding(tokens, table).to(out_dtype)


# --------------------------------------------------------------- rotary ----

def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float):
    """(P,) int positions → cos/sin (P, head_dim/2), float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


# ------------------------------------------------------------ attention ----

def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: int = 0,
                  chunk: int = 256) -> torch.Tensor:
    """Flash-style reference: query chunks, float32 softmax rows.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D) (kv already repeated to H).
    Scores are float32 (bf16 inputs multiply exactly in float32), masked
    with −1e30; the weights are cast to v's dtype before the product with
    v, as in the reference.  Peak memory O(B·chunk·H·Skv).
    """
    Sq, D = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = D ** -0.5
    kf = k.to(ct)
    kv_pos = torch.arange(Skv, device=q.device)
    outs = []
    for start in range(0, Sq, chunk):
        qc = q[:, start:start + chunk]
        s = torch.einsum("bchd,bshd->bchs", qc.to(ct), kf) * scale
        if causal:
            q_pos = q_offset + start + torch.arange(qc.shape[1],
                                                    device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]        # (c, Skv)
            s = s.masked_fill(~mask[None, :, None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bchs,bshd->bchd", p.to(v.dtype), v))
    return torch.cat(outs, dim=1)


@dataclasses.dataclass
class KVCache:
    """k/v: (B, S_max, K·D) per layer (the model stacks a layer axis in
    front), the head axis flat as in the reference.  Unlike the
    reference's immutable arrays, attention writes new keys and values
    into these tensors in place."""

    k: torch.Tensor
    v: torch.Tensor


def _grouped_decode(q, k, v, n_kv_heads: int, q_offset: int,
                    causal: bool) -> torch.Tensor:
    """One-token attention with G = H / K query heads per kv head: q
    (B, 1, H, D) against k, v (B, S, K, D) without repeating them — the
    reference's grouped-GQA einsum (float32 scores, −1e30 mask, weights
    cast to v's dtype)."""
    B, Sq, H, D = q.shape
    G = H // n_kv_heads
    ct = torch.promote_types(q.dtype, torch.float32)
    q5 = q.reshape(B, Sq, n_kv_heads, G, D)
    s = torch.einsum("bqkgd,bskd->bqkgs", q5.to(ct), k.to(ct)) * D ** -0.5
    if causal:
        kv_pos = torch.arange(k.shape[1], device=q.device)
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]              # (Sq, S)
        s = s.masked_fill(~mask[None, :, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def attention(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: float | None = 1e4,
              causal: bool = True, cache: KVCache | None = None,
              cache_pos: int | None = None,
              kv_source: torch.Tensor | None = None,
              impl: str = "reference", chunk: int = 256,
              qk_norm: bool = False) -> torch.Tensor:
    """Self- or cross-attention, x (B, Sq, d) → out (B, Sq, d); a cache is
    written in place.

    ``params`` maps wq, wk, wv, wo (flat layout) and, with ``qk_norm``,
    q_norm / k_norm (K7 on rows of ``head_dim``).  Modes, as the
    reference's:

      * train / score: ``cache=None`` — attention over x; causal with
        ``impl="pallas"`` takes K5, else :func:`_sdpa_chunked`;
      * prefill: a zeroed cache and ``cache_pos=0`` — rotary at positions
        ``cache_pos + i``, the new keys and values written into the cache
        at ``cache_pos`` (the reference's ``dynamic_update_slice``), then
        attention over the whole cache with unwritten slots masked;
      * decode: x (B, 1, d) and ``cache_pos`` the current length;
      * cross-attention: ``kv_source`` (B, S_src, d) gives the keys and
        values, without rotary (q has none either); or a cache with
        ``cache_pos=None`` holds them, precomputed at prefill, and is
        read as it is (no rotary, no k-norm, nothing written)."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl {impl!r} not one of "
                         f"{ATTENTION_IMPLS}")
    B, Sq, _ = x.shape
    G = n_heads // n_kv_heads
    q = dense(params["wq"], x).reshape(B, Sq, n_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
    base = 0
    if cache is not None and cache_pos is None:
        # cross-attention read: keys and values precomputed at prefill
        S_c = cache.k.shape[1]
        k = cache.k.reshape(B, S_c, n_kv_heads, head_dim)
        v = cache.v.reshape(B, S_c, n_kv_heads, head_dim)
    else:
        src = x if kv_source is None else kv_source
        Skv = src.shape[1]
        k = dense(params["wk"], src).reshape(B, Skv, n_kv_heads, head_dim)
        v = dense(params["wv"], src).reshape(B, Skv, n_kv_heads, head_dim)
        if qk_norm:
            k = rms_norm(k, params["k_norm"])
        if cache is not None:
            base = int(cache_pos)
        if rope_theta is not None and kv_source is None:
            cos, sin = rotary_embedding(
                base + torch.arange(Sq, device=x.device), head_dim,
                rope_theta)
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        if cache is not None:
            cache.k[:, base:base + Skv] = k.reshape(B, Skv, -1).to(
                cache.k.dtype)
            cache.v[:, base:base + Skv] = v.reshape(B, Skv, -1).to(
                cache.v.dtype)
            S_c = cache.k.shape[1]
            k = cache.k.reshape(B, S_c, n_kv_heads, head_dim)
            v = cache.v.reshape(B, S_c, n_kv_heads, head_dim)
    if G > 1 and Sq == 1:
        out = _grouped_decode(q, k, v, n_kv_heads, base, causal)
    else:
        if G > 1:   # GQA: repeat kv heads to H, as the reference does
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        if impl == "pallas" and causal and cache is None \
                and kv_source is None:
            out = dispatch.flash_attention(q, k, v, causal=True)
        else:
            out = _sdpa_chunked(q, k, v, causal=causal, q_offset=base,
                                chunk=chunk)
    return dense(params["wo"], out.reshape(B, Sq, n_heads * head_dim))


# ---------------------------------------------------------------- MLPs -----

def mlp(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(dense(params["wi_gate"], x)) * dense(params["wi_up"], x)
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(params["wi"], x), approximate="tanh")
    return dense(params["wo"], h)


class _CotangentCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def cotangent_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward casts the gradient to x's dtype — the
    counterpart of ``repro.models.layers.cotangent_cast``, the guard
    between the float32 head and the layer stack (a float32 gradient would
    otherwise run through every residual add).  Torch's own ``.float()``
    cast already hands back a gradient in x's dtype (``ToCopyBackward``),
    so on today's heads this is a no-op, as the reference measured its
    own; it pins the invariant at the reference's five call sites."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CotangentCast.apply(x)
    return x


# ---------------------------------------------------------------- loss -----

def token_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-position ``logsumexp(logits) − logits[label]`` in float32, over
    every column of ``logits`` (padded vocabulary columns included, as the
    reference)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    return lse - ll


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy (masked mean when ``mask`` is given)."""
    loss = token_cross_entropy(logits, labels)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
