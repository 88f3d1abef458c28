"""Dense / MoE decoder-only LM (olmo, granite, deepseek, qwen3, arctic,
grok) — the counterpart of ``repro.models.transformer.DecoderLM``: the
forward over a full sequence, and the serving path (``init_cache``,
``prefill``, ``decode_step``) with a KV cache.

The parameters mirror the reference's tree: ``embed`` (V_pad, d), one
block per layer (``ln1`` / ``ln2`` norm weights, ``attn`` wq/wk/wv/wo flat,
and ``mlp`` or, with ``moe_experts``, ``moe``: the
:class:`~repro_torch.models.moe.MoE` FFN), ``final_norm`` and ``head``
(d, V_pad).  A non-parametric norm has no parameter (the reference keeps a
(0,) placeholder leaf).  The layer stack runs as a Python loop in place
of the reference's ``scan``; each block runs under :func:`remat_wrap` per
``cfg.remat`` (the reference's sites: ``forward`` and ``prefill``), and
``forward`` passes the stack's output through
:func:`~repro_torch.models.layers.cotangent_cast` before the head, as the
reference does.  ``forward`` returns the MoE layers' summed aux loss (0.0
without experts), as the reference does.

Two numerics of the reference are kept on purpose:

* the head multiplies the activations (bf16 in OLMo) with the float32 head
  in float32 — JAX promotes the mixed einsum — so the head is never cast
  to the activation dtype;
* the logits keep every padded vocabulary column.

The cache is the reference's: a :class:`~repro_torch.models.layers.KVCache`
of (L, B, S_max, K·hd) tensors in the activation dtype.  Prefill and
decode write each layer's new keys and values into it in place and
return it.

Sharding: :meth:`DecoderLM.param_specs` and
:meth:`DecoderLM.cache_specs` are the reference's specs, keyed like
``named_parameters()``; a per-layer parameter's spec is the reference's
stacked one without its layer entry.  Under an ambient mesh
(``repro_torch.launch.mesh.use_mesh``) with DTensor parameters, each block
first redistributes its weights to their tensor-parallel specs — the
ZeRO-3 gather, which the reference leaves to GSPMD after pinning the
block's FSDP layout (its ``constrain_tree``) — and the activations are
constrained at the reference's sites (after the embedding and each block,
the vocab-parallel logits); the MoE FFN shards its experts as
:mod:`repro_torch.models.moe` says.  Without a mesh all of it is a no-op.
"""

from __future__ import annotations

import functools
import types

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import (KVCache, apply_norm, attention,
                                       attn_specs, cotangent_cast, lm_embed,
                                       lm_logits, mlp)
from repro_torch.models.moe import MoE, init_moe, moe_ffn, moe_specs
from repro_torch.models.sharding import (P, active_mesh, block_weights,
                                         param_spec, shard, subtree)

__all__ = ["DecoderLM", "remat_wrap", "REMAT_MODES"]

REMAT_MODES = ("none", "dots", "full")
# the matmuls without batch dimensions (x @ w: torch.matmul folds the
# leading axes into one mm); batched einsums (attention, the experts' bmm)
# are recomputed, as JAX's dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, remat: str):
    """``fn`` under activation recomputation per ``remat``, the counterpart
    of the reference's ``remat_wrap``: ``"none"`` keeps every activation;
    ``"full"`` (``jax.checkpoint``) keeps only ``fn``'s inputs and reruns
    it in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` (``dots_with_no_batch_dims_saveable``) also keeps the
    outputs of the matmuls without batch dimensions (a selective
    checkpoint policy).  Without grad (serving under ``inference_mode``)
    ``fn`` runs as it is."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not one of {REMAT_MODES}")
    if remat == "none":
        return fn
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


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
        if cfg.moe_experts:
            self.moe = MoE(cfg, device)
            return
        mlp_shapes = ({"wi_gate": (d, cfg.d_ff), "wi_up": (d, cfg.d_ff),
                       "wo": (cfg.d_ff, d)} if cfg.mlp_kind == "swiglu"
                      else {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)})
        self.mlp = nn.ParameterDict(
            {n: _param(s, cfg, device) for n, s in mlp_shapes.items()})


class DecoderLM(nn.Module):
    """``DecoderLM(cfg, device)``; ``device=None`` means the card (raises
    without CUDA).  Parameters are allocated uninitialised: fill them with
    :meth:`init_params` or load them (``repro_torch.convert``).  Raises
    ValueError for a family other than ``FAMILIES``, as the reference."""

    FAMILIES = ("dense", "moe")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} runs the families "
                             f"{self.FAMILIES}, got {cfg.family!r}")
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
        norm weights 1; the MoE FFN as :func:`~repro_torch.models.moe.
        init_moe`), drawn in place from ``generator``, which lives on the
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
            if cfg.moe_experts:
                init_moe(blk.moe, cfg, generator)
            else:
                for p in blk.mlp.values():
                    normal(p, p.shape[0])
            for p in (blk.ln1, blk.ln2):
                if p is not None:
                    p.fill_(1.0)
        if self.final_norm is not None:
            self.final_norm.fill_(1.0)
        normal(self.head, cfg.d_model)
        return self

    # ------------------------------------------------------------- specs --
    def _block_specs(self) -> dict[str, P]:
        """One block's specs, keyed like its ``named_parameters()``."""
        cfg = self.cfg
        s = {"attn." + k: v for k, v in attn_specs(cfg.qk_norm).items()}
        if cfg.norm_type == "rmsnorm":
            s["ln1"] = s["ln2"] = param_spec((None,))
        if cfg.moe_experts:
            s.update({"moe." + k: v for k, v in moe_specs(cfg).items()})
            return s
        ff = ({"wi_gate": (None, "ff"), "wi_up": (None, "ff"),
               "wo": ("ff", None)} if cfg.mlp_kind == "swiglu"
              else {"wi": (None, "ff"), "wo": ("ff", None)})
        s.update({"mlp." + k: param_spec(v) for k, v in ff.items()})
        return s

    def param_specs(self) -> dict[str, P]:
        """The reference's ``param_specs()`` (``transformer.py:105``) keyed
        like ``named_parameters()``, each per-layer spec without its
        stacked layer entry."""
        out = {"embed": param_spec(("vocab", None))}
        block = self._block_specs()
        for i in range(self.cfg.n_layers):
            out.update({f"blocks.{i}.{k}": v for k, v in block.items()})
        if self.final_norm is not None:
            out["final_norm"] = param_spec((None,))
        out["head"] = param_spec((None, "vocab"))
        return out

    def cache_specs(self) -> KVCache:
        spec = param_spec((None, "batch", None, "kv_heads"))
        return KVCache(spec, spec)

    def _gathered(self, blk: _Block) -> tuple:
        """(ln1, attn, ln2, the FFN: mlp's weights or the MoE's) of
        ``blk``; under a mesh each weight redistributed to its
        tensor-parallel spec (the ZeRO-3 gather at the top of the
        block)."""
        ffn = blk.moe if self.cfg.moe_experts else blk.mlp
        if active_mesh() is None:
            return blk.ln1, blk.attn, blk.ln2, ffn
        w = block_weights(blk, self._block_specs())
        if self.cfg.moe_experts:
            moe = subtree(w, "moe.")
            ffn = types.SimpleNamespace(
                dense_residual=subtree(moe, "dense_residual.") or None,
                **{k: moe[k] for k in ("router", "wi_gate", "wi_up", "wo")})
        else:
            ffn = subtree(w, "mlp.")
        return w.get("ln1"), subtree(w, "attn."), w.get("ln2"), ffn

    # ----------------------------------------------------------- forward --
    def _block(self, blk: _Block, x: torch.Tensor,
               cache: KVCache | None = None, cache_pos: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One layer → (x, the MoE aux loss or None without experts)."""
        cfg = self.cfg
        ln1, attn, ln2, ffn = self._gathered(blk)
        h = apply_norm(cfg.norm_type, x, ln1)
        x = x + attention(attn, h, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          rope_theta=cfg.rope_theta, causal=True,
                          cache=cache, cache_pos=cache_pos,
                          impl=cfg.attention_impl, chunk=cfg.attn_chunk,
                          qk_norm=cfg.qk_norm)
        h = apply_norm(cfg.norm_type, x, ln2)
        if cfg.moe_experts:
            m, aux = moe_ffn(ffn, h, cfg)
            return shard(x + m, "batch", "seq", None), aux
        x = x + mlp(ffn, h, cfg.mlp_kind)
        return shard(x, "batch", "seq", None), None

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V_pad) float32.  Both operands go to float32
        (exact for bf16), which is the reference's promoted einsum."""
        return lm_logits(self.cfg.norm_type, x, self.final_norm, self.head)

    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` (B, S) ints → (logits (B, S, V_pad) float32,
        the MoE layers' summed aux loss, 0.0 without experts) over the
        full sequence."""
        x = self._embed(batch["tokens"])
        aux = torch.zeros((), device=self.device)
        block = remat_wrap(self._block, self.cfg.remat)
        for blk in self.blocks:
            x, a = block(blk, x)
            if a is not None:
                aux = aux + a
        x = cotangent_cast(x)   # keep the backward at activation dtype
        return self.logits(x), aux

    def _embed(self, tokens) -> torch.Tensor:
        return lm_embed(self.embed, tokens, self.cfg.adtype, self.device)

    # ------------------------------------------------------------- cache --
    def init_cache(self, batch_size: int, max_seq: int) -> KVCache:
        """A zeroed cache: k and v (L, B, max_seq, K·hd) in the activation
        dtype on the model's device."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads * cfg.hd)
        return KVCache(*(torch.zeros(shape, dtype=cfg.adtype,
                                     device=self.device) for _ in range(2)))

    def _run_cached(self, x: torch.Tensor, cache: KVCache,
                    pos: int) -> torch.Tensor:
        # the reference remats the prefill's body, not decode's
        block = self._block if x.shape[1] == 1 else \
            remat_wrap(self._block, self.cfg.remat)
        for li, blk in enumerate(self.blocks):
            x, _ = block(blk, x, KVCache(cache.k[li], cache.v[li]), pos)
        return x

    def prefill(self, batch, cache: KVCache):
        """Full-prompt pass writing the cache from position 0; returns (the
        last position's logits (B, 1, V_pad) float32, cache)."""
        x = self._run_cached(self._embed(batch["tokens"]), cache, 0)
        # contiguous: K7 takes whole rows in order
        return self.logits(x[:, -1:, :].contiguous()), cache

    def decode_step(self, cache: KVCache, pos: int, tokens):
        """tokens (B, 1) at position ``pos`` → (logits (B, 1, V_pad)
        float32, cache)."""
        x = self._run_cached(self._embed(tokens), cache, int(pos))
        return self.logits(x), cache
