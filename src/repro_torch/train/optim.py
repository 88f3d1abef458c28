"""AdamW with float32 or 8-bit block-quantized moments — the counterpart of
``repro.train.optim``.

8-bit states (linear block quantization along the trailing axis) are what
let a bf16-parameter model keep its moments in 2 bytes a parameter: the
quantization error is re-absorbed every step by re-quantizing the
*updated* moment.  Everything is the reference's arithmetic, op for op,
in float32: the bias corrections are float32 powers of the float32 step
count, the clip is ``min(1, grad_clip / max(‖g‖, 1e-12))`` of the global
gradient norm, and rounding is to nearest even (``torch.round``, as
``jnp.round``).

The state is a dict: ``m`` and ``v`` keyed like the model's
``named_parameters()`` (a float32 tensor each, or ``{"q": int8, "scale":
float32}`` with ``bits8``) and the int32 ``count``.  :func:`adamw_update`
writes the new parameters into the model's tensors in place (the
reference returns new arrays; a second copy of an 8B model would not fit
beside its moments) and updates the moments in place.

Weight decay follows the reference's *stacked* layout.  The reference
stacks every per-layer parameter over a leading layer axis and decays a
leaf when ``ndim >= 2``, so its per-layer norm weights (L, d), qk-norm
weights and Mamba2's ``A_log`` / ``D`` / ``dt_bias`` (L, H) are decayed,
and only the unstacked 1-D leaves (``final_norm``, ``enc_norm``, Zamba2's
shared block's norms) are not.  The port keeps one module per layer, so
the same tensors are 1-D here: a parameter inside a per-layer
``ModuleList`` (a name with an integer component, ``blocks.3.ln1``)
counts its ``ndim + 1`` (:func:`stacked_ndim`).  The reference's slice-wise
map over giant stacked leaves (``BIG_LEAF_ELEMS``) only bounds its
transients; here every parameter is one layer's slice already.

One difference stays: with ``bits8`` a per-layer *scalar* (the VLM's cross
gates) is quantized on its own, where the reference's stacked (n_cross,)
leaf shares one scale across the cross blocks.  ``run_training`` takes
``bits8`` only for bf16 parameters (Arctic, Grok), which have none.
Sharded parameters (DTensors, the mesh planner's route) take the same
code: the moments are DTensors in their parameters' layout, the global
norm sums each device's partial sums, and an 8-bit moment's per-row scale
is a max across the devices that split its row (DTensor reduces the
partial max), so the scale is replicated where the reference's
:func:`opt_state_specs` drops the last entry.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWConfig", "QBLOCK", "quantize_blockwise",
           "dequantize_blockwise", "stacked_ndim", "adamw_init",
           "adamw_update", "opt_state_specs"]

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    bits8: bool = False  # 8-bit block-quantized m/v


# ------------------------------------------------------ 8-bit quantization -
# Shape-preserving row-wise quantization: q is int8 in the parameter's
# shape and scale is one float32 per trailing row.

def quantize_blockwise(x: torch.Tensor) -> dict:
    x = x.float()
    if x.dim() == 0:
        scale = torch.clamp(x.abs() / 127.0, min=1e-12)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_blockwise(qd: dict, shape) -> torch.Tensor:
    return (qd["q"].float() * qd["scale"]).reshape(shape)


# ----------------------------------------------------------------- AdamW ---

def stacked_ndim(name: str, p: torch.Tensor) -> int:
    """The ndim of ``p``'s leaf in the reference's stacked tree: one more
    for a parameter of a per-layer module (a name with an integer
    component, ``blocks.3.ln1`` / ``cross.0.gate``)."""
    return p.dim() + any(part.isdigit() for part in name.split("."))


def _moment_init(p: torch.Tensor, bits8: bool):
    z = torch.zeros_like(p, dtype=torch.float32,
                         memory_format=torch.contiguous_format)
    return quantize_blockwise(z) if bits8 else z


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments for ``params`` (name → tensor) and a zero count."""
    dev = next(iter(params.values())).device if params else None
    return {"m": {n: _moment_init(p, cfg.bits8) for n, p in params.items()},
            "v": {n: _moment_init(p, cfg.bits8) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(grads: dict) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ g²)`` in float32, leaf by leaf in ``grads``' order
    (the reference's ``_global_norm``)."""
    total = None
    for g in grads.values():
        if g.numel() == 0:
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: AdamWConfig):
    """One AdamW step: ``grads`` and ``params`` keyed alike (the model's
    ``named_parameters()``).  Writes the new parameters into ``params``'
    tensors and the moments into ``opt_state`` in place; returns
    (params, opt_state, the global gradient norm before clipping)."""
    count = opt_state["count"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    c = count.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=c.device), c)
    for name, p in params.items():
        if p.numel() == 0:   # placeholder leaves (non-parametric norms)
            continue
        g = grads[name].float() * clip
        m, v = opt_state["m"][name], opt_state["v"][name]
        if cfg.bits8:
            m_f = dequantize_blockwise(m, p.shape)
            v_f = dequantize_blockwise(v, p.shape)
        else:
            m_f, v_f = m, v
        m_f.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v_f.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        del g
        # p - lr·((m/bc1) / (sqrt(v/bc2) + eps) + wd·p), op for op, in
        # place where a temporary would otherwise stay live (8-bit AdamW on
        # a 1.6e9-element expert leaf then fits beside its model)
        den = torch.sqrt(v_f / bc2).add_(cfg.eps)
        upd = (m_f / bc1).div_(den)
        del den
        if stacked_ndim(name, p) >= 2:   # decoupled decay on matrices only
            upd.add_(p.float() * cfg.weight_decay)
        # p + (-lr·upd) is p - lr·upd exactly (p.float() is p itself for a
        # float32 parameter, so it is never written in place)
        p.copy_(upd.mul_(-cfg.lr).add_(p))
        del upd
        if cfg.bits8:
            opt_state["m"][name] = quantize_blockwise(m_f)
            opt_state["v"][name] = quantize_blockwise(v_f)
    opt_state["count"] = count
    return params, opt_state, gnorm


def opt_state_specs(param_specs: dict, cfg: AdamWConfig) -> dict:
    """The moments' specs, mirroring the parameters' (the reference's
    ``opt_state_specs``, ``optim.py:152``): with ``bits8`` q keeps its
    parameter's spec and the per-row scale drops the last (reduced) entry."""
    from repro_torch.models.sharding import P

    def leaf(spec):
        spec = P(*(spec or ()))
        if cfg.bits8:
            entries = tuple(spec)
            return {"q": P(*entries),
                    "scale": P(*(entries[:-1] + (None,))) if entries
                    else P()}
        return spec

    moments = {n: leaf(s) for n, s in param_specs.items()}
    return {"m": moments, "v": moments, "count": P()}
