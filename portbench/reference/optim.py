"""AdamW in plain float32 PyTorch, as the port's trainer sets it
(``src/repro_torch/train/optim.py``): the gradient clipped to a global
norm of ``grad_clip``, the moments' bias corrections, decoupled weight
decay on every leaf that the layer-stacked parameter tree holds as a
matrix (a 2-D leaf, or any leaf of a per-layer module: a name with an
integer part), p ← p − lr·((m/bc1)/(√(v/bc2) + eps) + wd·p)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def decayed(name: str, p: torch.Tensor) -> bool:
    return p.dim() + any(part.isdigit() for part in name.split(".")) >= 2


@torch.no_grad()
def clipped(grads: dict, cfg: AdamW) -> dict:
    """The gradient as the update takes it: scaled by min(1, clip / ‖g‖)."""
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
    scale = min(1.0, cfg.grad_clip / max(float(norm), 1e-12))
    return {n: g * scale for n, g in grads.items()}


@torch.no_grad()
def step(params: dict, grads: dict, state: dict, cfg: AdamW) -> None:
    """One update of ``params`` in place from ``grads`` (both name →
    tensor); ``state`` holds the moments and the count, made on the first
    call."""
    g = clipped(grads, cfg)
    t = state["count"] = state.get("count", 0) + 1
    bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    for n, p in params.items():
        m = state.setdefault("m." + n, torch.zeros_like(p))
        v = state.setdefault("v." + n, torch.zeros_like(p))
        m.mul_(cfg.b1).add_(g[n], alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g[n], g[n], value=1 - cfg.b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decayed(n, p):
            upd = upd + cfg.weight_decay * p
        p.sub_(cfg.lr * upd)
