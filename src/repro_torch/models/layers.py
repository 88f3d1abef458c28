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
grouped einsum and never repeats the keys.

The reference's mesh constraints sit where it puts them: ``shard_div`` on
q, k and v (heads over ``model`` where they divide), ``shard`` on the MLP's
hidden activations (``ff``).  Without an ambient mesh they are identities;
with one, the tensors are DTensors and the kernels run on their local
shards (:mod:`repro_torch.kernels.dispatch`).  Grouped kv heads that do
not divide the ``model`` axis stay replicated, and the repeat to H heads
hands each ``model`` rank the kv heads of its own query heads' groups.
The loss is vocab-parallel: its logsumexp reduces the local shards' max
and sum across the vocabulary's ranks, and the label's logit is a masked
sum over each rank's own columns (:func:`token_cross_entropy`).

Training: every layer here is differentiable on both routes (K7 through
its backward kernel on the card).  :func:`embed_lookup`'s table gradient
mirrors the reference's one-hot matmul, rounded to the activation dtype
as that product is; :func:`cotangent_cast` is the reference's guard
between the float32 head and the layer stack.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch, ref
from repro_torch.models.sharding import (constrain_tree, gather_inner,
                                         gather_inner_grad, keep_grad_layout,
                                         param_spec, settle, shard, shard_div,
                                         to_local)

__all__ = [
    "rms_norm", "layer_norm", "apply_norm", "dense", "embed_lookup",
    "lm_embed", "lm_logits",
    "rotary_embedding", "apply_rotary", "KVCache", "attention", "mlp",
    "cotangent_cast", "token_cross_entropy", "cross_entropy_loss",
    "attn_specs",
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
    matmul, as the reference's ``preferred_element_type=x.dtype``).
    Sequence-split DTensor rows are gathered first (Megatron's gather
    into the tensor-parallel region)."""
    if not hasattr(x, "placements"):
        return torch.matmul(x, w.to(x.dtype))
    return gather_inner_grad(torch.matmul(gather_inner(x), w.to(x.dtype)))


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


def lm_embed(table: torch.Tensor, tokens, out_dtype: torch.dtype,
             device) -> torch.Tensor:
    """The reference's ``embed_tokens``: rows of ``table`` for ``tokens``
    (a DTensor, or anything ``torch.as_tensor`` takes onto ``device``).
    Under a mesh the table is gathered to its ("vocab", None) spec and the
    rows are constrained to ("batch", "seq", None)."""
    if not hasattr(tokens, "placements"):
        tokens = torch.as_tensor(tokens, device=device)
    table = constrain_tree({"embed": table},
                           {"embed": param_spec(("vocab", None))})["embed"]
    return shard(embed_lookup(table, tokens, out_dtype), "batch", "seq",
                 None)


def lm_logits(norm_type: str, x: torch.Tensor, final_norm,
              head: torch.Tensor) -> torch.Tensor:
    """The reference's ``logits``: (B, S, d) → (B, S, V_pad) float32, the
    final norm, then both operands in float32 (exact for bf16), its
    promoted einsum.  Under a mesh the head is gathered to its (None,
    "vocab") spec and the logits are vocab-parallel."""
    ends = constrain_tree(
        {k: v for k, v in (("final_norm", final_norm), ("head", head))
         if v is not None},
        {"final_norm": param_spec((None,)),
         "head": param_spec((None, "vocab"))})
    x = apply_norm(norm_type, x, ends.get("final_norm"))
    out = gather_inner_grad(
        torch.matmul(gather_inner(x).float(), ends["head"].float()))
    return shard(out, "batch", None, "vocab")   # vocab-parallel logits


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


def attn_specs(qk_norm: bool = False) -> dict:
    """Specs for one attention site (flat-weight layout), the reference's
    ``attn_specs``: wk / wv pass no divisibility, so on ``model`` 16 their
    1024 columns split into 64-column blocks, half of a 128-wide head."""
    s = {"wq": param_spec((None, "heads")),
         "wk": param_spec((None, "kv_heads")),
         "wv": param_spec((None, "kv_heads")),
         "wo": param_spec(("heads", None))}
    if qk_norm:
        s["q_norm"] = param_spec((None,))
        s["k_norm"] = param_spec((None,))
    return s


def _reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)`` for a reshape that keeps the leading dims and
    splits or merges the trailing ones.  A DTensor split on a trailing dim
    that the reshape cannot keep — a head count that its shards do not
    divide (wk's 64-column blocks of 128-wide heads on ``model`` 16), or a
    merged dim after the first — is gathered on that dim first, as GSPMD
    reshards there."""
    pl = getattr(t, "placements", None)
    if pl is None:
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate
    c = 0
    while c < min(t.dim(), len(shape)) and t.shape[c] == shape[c]:
        c += 1
    mesh = t.device_mesh
    ways = 1
    for p, n in zip(pl, mesh.shape):
        if p.is_shard(c):
            ways *= n
    new = []
    for p in pl:
        if p.is_shard() and (p.dim > c or (p.dim == c and c < len(shape)
                                           and shape[c] != -1
                                           and shape[c] % ways)):
            p = Replicate()
        new.append(p)
    if tuple(new) != tuple(pl):
        t = t.redistribute(mesh, new)
    # the gradient comes back in the layout the reshape gave, which its
    # backward can undo (a split of merged heads that the ways do not
    # divide, say, cannot be viewed back into heads)
    return keep_grad_layout(t.reshape(shape))


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
    q5 = _reshape(q, B, Sq, n_kv_heads, G, D)
    s = torch.einsum("bqkgd,bskd->bqkgs", q5.to(ct), k.to(ct)) * D ** -0.5
    if causal:
        kv_pos = torch.arange(k.shape[1], device=q.device)
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]              # (Sq, S)
        s = s.masked_fill(~mask[None, :, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype), v)
    return _reshape(out, B, Sq, H, D)


def _attend(q, k, v, *, causal: bool, q_offset: int, chunk: int,
            flash: bool) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, K, D): the grouped
    einsum for one grouped query, else kv repeated to H (as the reference
    does) and K5 (``flash``) or the chunked route."""
    G = q.shape[2] // k.shape[2]
    if G > 1 and q.shape[1] == 1:
        return _grouped_decode(q, k, v, k.shape[2], q_offset, causal)
    if G > 1:   # GQA: repeat kv heads to H, as the reference does
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    if flash:
        return dispatch.flash_attention(q, k, v, causal=True)
    return _sdpa_chunked(q, k, v, causal=causal, q_offset=q_offset,
                         chunk=chunk)


def _split_of(placements, mesh, dim: int) -> tuple[int, int]:
    """(this device's index, the number of ways) of the split of ``dim``
    by ``placements``: mesh dims split it major to minor, in mesh order."""
    coord = mesh.get_coordinate()
    idx, ways = 0, 1
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            idx, ways = idx * mesh.size(i) + coord[i], ways * mesh.size(i)
    return idx, ways


def _on_local_heads(fn, q, k, v) -> torch.Tensor:
    """``fn`` (:func:`_attend`) on each device's local shards of DTensors
    q (B, Sq, H, D), k and v (B, Skv, K, D); the result is a DTensor laid
    out as q.  Attention is independent per row and per head, so q keeps
    its batch and head splits (any other split is gathered), k and v its
    batch split.  kv heads split as q's heads when the ways divide K;
    else they are replicated and each device takes the kv heads of its own
    query heads' groups (a device whose query heads straddle groups gets q
    gathered).  A replicated kv operand's gradient leaves each device as a
    partial sum over its heads' devices."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    G = H // K
    keep = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
                 for p in q.placements)
    _, ways = _split_of(keep, mesh, 2)
    Hl = H // ways
    if K % ways and not (Hl % G == 0 or G % Hl == 0):
        keep = tuple(Replicate() if p.is_shard(2) else p for p in keep)
        ways, Hl = 1, H
    if keep != tuple(q.placements):
        q = q.redistribute(mesh, keep)
    split_kv = K % ways == 0
    kv_pl = tuple(p if p.is_shard(0) or (split_kv and p.is_shard(2))
                  else Replicate() for p in keep)
    k, v = (t if tuple(t.placements) == kv_pl else t.redistribute(mesh, kv_pl)
            for t in (k, v))
    kv_grad = tuple(Partial() if (p.is_shard(2) and not split_kv) else pl
                    for p, pl in zip(keep, kv_pl))
    idx, _ = _split_of(keep, mesh, 2)
    lo = (idx * Hl) // G
    hi = ((idx + 1) * Hl - 1) // G + 1

    def local(ql, kl, vl):
        if not split_kv:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl)

    out = local(to_local(q, keep), to_local(k, kv_grad), to_local(v, kv_grad))
    return DTensor.from_local(out.contiguous(), mesh, keep, run_check=False,
                              shape=q.shape, stride=q.stride())


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
    x = gather_inner(x)     # sequence-split rows gathered once for q, k, v
    if kv_source is not None:
        kv_source = gather_inner(kv_source)
    q = _reshape(dense(params["wq"], x), B, Sq, n_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
    base = 0
    if cache is not None and cache_pos is None:
        # cross-attention read: keys and values precomputed at prefill
        S_c = cache.k.shape[1]
        k = _reshape(cache.k, B, S_c, n_kv_heads, head_dim)
        v = _reshape(cache.v, B, S_c, n_kv_heads, head_dim)
    else:
        src = x if kv_source is None else kv_source
        Skv = src.shape[1]
        k = _reshape(dense(params["wk"], src), B, Skv, n_kv_heads,
                     head_dim)
        v = _reshape(dense(params["wv"], src), B, Skv, n_kv_heads,
                     head_dim)
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
            cache.k[:, base:base + Skv] = _reshape(k, B, Skv, -1).to(
                cache.k.dtype)
            cache.v[:, base:base + Skv] = _reshape(v, B, Skv, -1).to(
                cache.v.dtype)
            S_c = cache.k.shape[1]
            k = _reshape(cache.k, B, S_c, n_kv_heads, head_dim)
            v = _reshape(cache.v, B, S_c, n_kv_heads, head_dim)
    # pin head-parallelism where the heads divide the model axis
    q = shard_div(q, ("batch", None, "heads", None))
    k = shard_div(k, ("batch", None, "kv_heads", None))
    v = shard_div(v, ("batch", None, "kv_heads", None))
    flash = impl == "pallas" and causal and cache is None \
        and kv_source is None
    core = functools.partial(_attend, causal=causal, q_offset=base,
                             chunk=chunk, flash=flash)
    out = _on_local_heads(core, q, k, v) if hasattr(q, "placements") \
        else core(q, k, v)
    return dense(params["wo"],
                 _reshape(out, B, Sq, n_heads * head_dim))


# ---------------------------------------------------------------- MLPs -----

def mlp(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    x = gather_inner(x)     # sequence-split rows gathered once
    if kind == "swiglu":
        h = F.silu(dense(params["wi_gate"], x)) * dense(params["wi_up"], x)
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(params["wi"], x), approximate="tanh")
    h = shard(h, "batch", None, "ff")
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
    if not _split_last(logits):
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None].long())
        if hasattr(ll, "placements"):   # reduce a masked partial
            ll = settle(ll)
        return lse - ll[..., 0]
    # vocab-parallel: the shards' max and sum reduce across the vocabulary's
    # devices; the label's logit is a masked sum of each device's own
    # columns (DTensor's gather would take its gradient over the whole
    # vocabulary of the global batch).  Each per-row result, and its
    # gradient, is laid out as the logits' rows: split over the batch axes
    # only, so nothing of (B, S, V) is ever gathered
    from torch.distributed.tensor import Replicate
    mesh, last = logits.device_mesh, logits.dim() - 1
    rows = tuple(p if p.is_shard() and p.dim < last else Replicate()
                 for p in logits.placements)

    def per_row(t):
        if tuple(t.placements) != rows:
            t = t.redistribute(mesh, rows)
        return keep_grad_layout(t)

    m = per_row(logits.detach().amax(dim=-1, keepdim=True))
    total = per_row(torch.exp(logits - m).sum(-1, keepdim=True))
    ll = per_row((logits * _label_onehot(logits, labels)).sum(-1))
    return (m + torch.log(total))[..., 0] - ll


def _label_onehot(logits, labels):
    """A DTensor laid out as ``logits`` (B, S, V) that is 1 at each row's
    label column and 0 elsewhere, built on each device from its rows'
    labels and its own vocabulary columns (no (B, S, V) gather)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl, last = logits.device_mesh, logits.placements, logits.dim() - 1
    lab_pl = tuple(p if p.is_shard() and p.dim < last else Replicate()
                   for p in pl)
    if not hasattr(labels, "placements"):
        labels = DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
    if tuple(labels.placements) != lab_pl:
        labels = labels.redistribute(mesh, lab_pl)
    idx, ways = _split_of(pl, mesh, last)
    width = -(-logits.shape[-1] // ways)        # torch.chunk's piece
    local = logits.to_local()
    cols = idx * width + torch.arange(local.shape[-1], device=local.device)
    hot = (labels.to_local().long()[..., None] == cols).to(local.dtype)
    return DTensor.from_local(hot, mesh, pl, run_check=False,
                              shape=logits.shape, stride=logits.stride())


def _split_last(x: torch.Tensor) -> bool:
    """Whether a DTensor's last dim is split over a mesh dim of size > 1."""
    pl = getattr(x, "placements", None)
    if pl is None:
        return False
    sizes = x.device_mesh.shape
    return any(p.is_shard(x.dim() - 1) and n > 1 for p, n in zip(pl, sizes))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy (masked mean when ``mask`` is given)."""
    loss = token_cross_entropy(logits, labels)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
