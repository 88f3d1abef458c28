"""Zamba2-style hybrid (arXiv:2411.15242) — the counterpart of
``repro.models.hybrid.Zamba2LM`` for ``family="hybrid"``: a Mamba2 backbone
plus one *shared* attention block (a single parameter set) applied before
every group of ``shared_attn_every`` SSM layers.

With L layers there are ⌈L / every⌉ attention sites; site s runs the shared
block and then the Mamba2 blocks ``[s·every, min((s+1)·every, L))`` — the
last group is ragged when ``every`` does not divide L (Zamba2-1.2B: 38 =
6 × 6 + 2, 7 sites).  The parameters mirror the reference's tree:
``embed`` (V_pad, d), ``blocks`` (the Mamba2 blocks of
``repro_torch.models.mamba2``, one per layer), ``shared_attn`` (``ln1``,
``attn`` wq/wk/wv/wo flat, ``ln2``, ``mlp``), ``final_norm`` and ``head``
(d, V_pad).  The groups run as Python loops in place of the reference's
``lax.scan``.  Without a cache, with ``cfg.remat`` other than "none", each
attention site is recomputed whole in the backward (the reference's
``jax.checkpoint`` there takes no policy) and each Mamba2 block runs under
``remat_wrap``; a prefill's blocks too, a decode step's not; ``forward``
casts the gradient back to the activation dtype before the head.

Kernels, through ``repro_torch.kernels.dispatch``: every Mamba2 block's
scan runs K6 and every RMSNorm K7; the shared block's attention runs K5
when there is no cache and the config asks for ``attention_impl="pallas"``,
and ``layers._sdpa_chunked`` with a cache, exactly as the reference.

Serving: :class:`HybridCache` holds the Mamba2 caches stacked over the L
layers (``ssm``) and one KV cache per attention site (``attn``): the
shared block has one parameter set but its keys and values differ per
site.  Prefill and decode write both in place and return the cache.

Sharding: :meth:`Zamba2LM.param_specs` and :meth:`Zamba2LM.cache_specs` are
the reference's, keyed like ``named_parameters()`` (the Mamba2 blocks'
per-layer specs without their layer entry, the shared block's as they
are).  Under an ambient mesh the shared block gathers its weights to their
tensor-parallel specs at each site (it is one parameter set, gathered once
a site) and its output is constrained as the reference's (``hybrid.py:116``),
as are the embedded tokens and the vocab-parallel logits; the Mamba2
blocks shard as :mod:`repro_torch.models.mamba2` says.
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
from repro_torch.models.mamba2 import (SSMCache, _Block, _param,
                                       init_mamba_block, mamba_block,
                                       mamba_block_specs, ssm_cache_specs)
from repro_torch.models.sharding import (P, active_mesh, block_weights,
                                         param_spec, shard, subtree)
from repro_torch.models.transformer import remat_wrap

__all__ = ["Zamba2LM", "HybridCache"]


@dataclasses.dataclass
class HybridCache:
    ssm: SSMCache  # stacked (L, …)
    attn: KVCache  # stacked (n_sites, …)


class _SharedBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd, pd = cfg.d_model, cfg.hd, cfg.pdtype
        rms = cfg.norm_type == "rmsnorm"
        self.ln1 = _param((d,), pd, device) if rms else None
        self.ln2 = _param((d,), pd, device) if rms else None
        self.attn = nn.ParameterDict({
            n: _param(s, pd, device) for n, s in (
                ("wq", (d, cfg.n_heads * hd)),
                ("wk", (d, cfg.n_kv_heads * hd)),
                ("wv", (d, cfg.n_kv_heads * hd)),
                ("wo", (cfg.n_heads * hd, d)))})
        shapes = ({"wi_gate": (d, cfg.d_ff), "wi_up": (d, cfg.d_ff),
                   "wo": (cfg.d_ff, d)} if cfg.mlp_kind == "swiglu"
                  else {"wi": (d, cfg.d_ff), "wo": (cfg.d_ff, d)})
        self.mlp = nn.ParameterDict(
            {n: _param(s, pd, device) for n, s in shapes.items()})


class Zamba2LM(nn.Module):
    """``Zamba2LM(cfg, device)``; ``device=None`` means the card (raises
    without CUDA).  Parameters are allocated uninitialised: fill them with
    :meth:`init_params` or load them (``repro_torch.convert``).  Raises
    ValueError when ``cfg.shared_attn_every`` is not positive (the
    reference asserts it)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba2LM runs the hybrid family, got "
                             f"{cfg.family!r}")
        if cfg.shared_attn_every <= 0:
            raise ValueError(f"a hybrid needs shared_attn_every > 0, got "
                             f"{cfg.shared_attn_every}")
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        dev, d, vp = self.device, cfg.d_model, cfg.vocab_padded
        self.embed = _param((vp, d), cfg.pdtype, dev)
        self.blocks = nn.ModuleList(_Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.shared_attn = _SharedBlock(cfg, dev)
        self.final_norm = (_param((d,), cfg.pdtype, dev)
                           if cfg.norm_type == "rmsnorm" else None)
        self.head = _param((d, vp), cfg.pdtype, dev)

    @property
    def n_sites(self) -> int:
        cfg = self.cfg
        return -(-cfg.n_layers // cfg.shared_attn_every)

    def _group(self, s: int) -> tuple[int, int]:
        cfg = self.cfg
        lo = s * cfg.shared_attn_every
        return lo, min(lo + cfg.shared_attn_every, cfg.n_layers)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Zamba2LM":
        """Random weights at the reference's scales (normal × fan_in^-½,
        the Mamba2 blocks as ``Mamba2LM.init_params``, norm weights 1)
        drawn from ``generator``, which lives on the model's device.  Same
        seed, same weights; not the reference's numbers (``jax.random``
        differs)."""
        cfg = self.cfg

        def normal(p: torch.Tensor, fan_in: int) -> None:
            p.normal_(generator=generator).mul_(fan_in ** -0.5)

        normal(self.embed, cfg.d_model)
        for blk in self.blocks:
            init_mamba_block(blk, cfg, generator)
        sp = self.shared_attn
        for group in (sp.attn, sp.mlp):
            for p in group.values():
                normal(p, p.shape[0])
        for p in (sp.ln1, sp.ln2, self.final_norm):
            if p is not None:
                p.fill_(1.0)
        normal(self.head, cfg.d_model)
        return self

    # ------------------------------------------------------------- specs --
    def _shared_specs(self) -> dict[str, P]:
        """The shared block's specs, keyed like its
        ``named_parameters()``."""
        cfg = self.cfg
        s = {"attn." + k: v for k, v in attn_specs().items()}
        if cfg.norm_type == "rmsnorm":
            s["ln1"] = s["ln2"] = param_spec((None,))
        ff = ({"wi_gate": (None, "ff"), "wi_up": (None, "ff"),
               "wo": ("ff", None)} if cfg.mlp_kind == "swiglu"
              else {"wi": (None, "ff"), "wo": ("ff", None)})
        s.update({"mlp." + k: param_spec(v) for k, v in ff.items()})
        return s

    def param_specs(self) -> dict[str, P]:
        """The reference's ``param_specs()`` (``hybrid.py:82``) keyed like
        ``named_parameters()``."""
        out = {"embed": param_spec(("vocab", None))}
        block = mamba_block_specs(self.cfg)
        for i in range(self.cfg.n_layers):
            out.update({f"blocks.{i}.{k}": v for k, v in block.items()})
        out.update({f"shared_attn.{k}": v
                    for k, v in self._shared_specs().items()})
        if self.final_norm is not None:
            out["final_norm"] = param_spec((None,))
        out["head"] = param_spec((None, "vocab"))
        return out

    def cache_specs(self) -> HybridCache:
        kv = param_spec((None, "batch", None, "kv_heads"))
        return HybridCache(ssm_cache_specs(), KVCache(kv, kv))

    # ------------------------------------------------------------ pieces --
    def _shared_block(self, x: torch.Tensor, cache: KVCache | None = None,
                      cache_pos: int | None = None) -> torch.Tensor:
        cfg, sp = self.cfg, self.shared_attn
        ln1, attn, ln2, ffn = sp.ln1, sp.attn, sp.ln2, sp.mlp
        if active_mesh() is not None:               # the ZeRO-3 gather
            w = block_weights(sp, self._shared_specs())
            ln1, ln2 = w.get("ln1"), w.get("ln2")
            attn, ffn = subtree(w, "attn."), subtree(w, "mlp.")
        h = apply_norm(cfg.norm_type, x, ln1)
        x = x + attention(attn, h, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          rope_theta=cfg.rope_theta, causal=True,
                          cache=cache, cache_pos=cache_pos,
                          impl=cfg.attention_impl, chunk=cfg.attn_chunk)
        h = apply_norm(cfg.norm_type, x, ln2)
        return shard(x + mlp(ffn, h, cfg.mlp_kind), "batch", "seq", None)

    def _run(self, x: torch.Tensor, cache: HybridCache | None = None,
             cache_pos: int | None = None,
             decode: bool = False) -> torch.Tensor:
        """The body shared by forward / prefill / decode: per site the
        shared block, then its group of Mamba2 blocks."""
        cfg = self.cfg
        shared = self._shared_block
        if cache is None and cfg.remat != "none":
            # the reference remats each attention site whole: otherwise the
            # backward keeps every site's attention internals live
            shared = remat_wrap(shared, "full")
        block = mamba_block if decode else remat_wrap(mamba_block, cfg.remat)
        for s in range(self.n_sites):
            site = None if cache is None else \
                KVCache(cache.attn.k[s], cache.attn.v[s])
            x = shared(x, site, cache_pos)
            lo, hi = self._group(s)
            for li in range(lo, hi):
                layer = None if cache is None else \
                    SSMCache(cache.ssm.state[li], cache.ssm.conv[li])
                x = block(self.blocks[li], x, cfg, layer, decode)
        return x

    # -------------------------------------------------------------- API ---
    def _embed(self, tokens) -> torch.Tensor:
        return lm_embed(self.embed, tokens, self.cfg.adtype, self.device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) → (B, S, V_pad) float32: the final norm, then both
        operands in float32 (exact for bf16), the reference's promoted
        einsum; vocab-parallel under a mesh."""
        return lm_logits(self.cfg.norm_type, x, self.final_norm, self.head)

    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` (B, S) ints → (logits (B, S, V_pad) float32,
        aux loss 0.0) over the full sequence."""
        x = self._run(self._embed(batch["tokens"]))
        x = cotangent_cast(x)   # keep the backward at activation dtype
        return self.logits(x), torch.zeros((), device=self.device)

    def init_cache(self, batch_size: int, max_seq: int) -> HybridCache:
        """A zeroed cache: ssm state (L, B, H, N, P) float32 and conv
        (L, B, k−1, d_inner + 2N), attn k and v (n_sites, B, max_seq, K·hd),
        both in the activation dtype."""
        cfg, dev = self.cfg, self.device
        L = cfg.n_layers
        ssm = SSMCache(
            torch.zeros((L, batch_size, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_head_dim), dtype=torch.float32, device=dev),
            torch.zeros((L, batch_size, cfg.ssm_conv - 1,
                         cfg.d_inner + 2 * cfg.ssm_state), dtype=cfg.adtype,
                        device=dev))
        shape = (self.n_sites, batch_size, max_seq, cfg.n_kv_heads * cfg.hd)
        return HybridCache(ssm, KVCache(
            *(torch.zeros(shape, dtype=cfg.adtype, device=dev)
              for _ in range(2))))

    def prefill(self, batch, cache: HybridCache):
        """Full-prompt pass writing the cache from position 0; returns (the
        last position's logits (B, 1, V_pad) float32, cache)."""
        x = self._run(self._embed(batch["tokens"]), cache, 0)
        # contiguous: K7 takes whole rows in order
        return self.logits(x[:, -1:, :].contiguous()), cache

    def decode_step(self, cache: HybridCache, pos: int, tokens):
        """tokens (B, 1) at position ``pos`` → (logits (B, 1, V_pad)
        float32, cache)."""
        x = self._run(self._embed(tokens), cache, int(pos), decode=True)
        return self.logits(x), cache
