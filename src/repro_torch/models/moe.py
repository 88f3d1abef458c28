"""Mixture-of-Experts FFN — the counterpart of ``repro.models.moe``: top-k
routing with capacity-bounded grouped dispatch (GShard / Switch style).

Tokens go in groups of g = min(``moe_group_size``, tokens), the last one
zero-padded to a whole group.  Each expert takes at most
C = max(⌊g·k / E · cf⌋, 1) (token, choice) pairs a group, in FIFO order
over the token-major (g·k) flattening (token t's second choice before
token t+1's first); the pairs past C are dropped and add nothing, so
their residual passes through.  The router is float32 inside a bf16
model; the top-k gates are normalised by max(sum, 1e-9); the aux loss is
the Switch load-balance term over every row of every group, the padded
rows included.  Arctic's dense residual MLP runs on the FFN's input and is
added before the final cast.

The reference moves tokens with one-hot einsums over (G, g, E, C)
dispatch and combine tensors.  Here the same values move by index:

* dispatch gathers each slot's token (or a zero row for an empty slot)
  into an (E, G·C, d) buffer — bitwise the reference's ``expert_in``,
  since each slot holds one token or zeros;
* the expert GEMMs are three ``bmm`` over the experts, in the activation
  dtype, as the reference's ``GEcd,Edf->GEcf`` einsums;
* combine is the gate-weighted sum of a token's kept choices, gates
  rounded to the activation dtype as the reference's ``comb``, the sum in
  float32 and one rounding to the activation dtype — what the reference's
  ``GgEc,GEcd->Ggd`` computes, since each (expert, slot) of a token has
  exactly one non-zero choice.

Top-k keeps the reference's order on ties (``jax.lax.top_k`` puts the
lower index first): a stable descending sort.  The zero-padded rows of the
last group tie on every expert and pick experts 0 and 1, as there.  Every
shape is fixed by the config and the token count, never by the routing,
so the function also runs on tensors without data.

The reference's ``_expert_axes`` and ``moe_specs`` place the experts on a
mesh and have no counterpart on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import mlp

__all__ = ["MoE", "capacity", "moe_ffn", "init_moe"]


def capacity(cfg: ModelConfig, tokens: int) -> tuple[int, int, int]:
    """(g, G, C) for ``tokens`` tokens: the group size, the number of
    groups and each expert's capacity a group — the reference's Python
    expressions."""
    g = min(cfg.moe_group_size, tokens)
    G = -(-tokens // g)
    C = max(int(g * cfg.moe_top_k / cfg.moe_experts
                * cfg.moe_capacity_factor), 1)
    return g, G, C


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MoE(nn.Module):
    """One MoE FFN's parameters, the reference's tree: ``router`` (d, E)
    float32, ``wi_gate`` / ``wi_up`` (E, d, f) and ``wo`` (E, f, d) in the
    parameter dtype, and with ``moe_dense_residual`` a SwiGLU
    ``dense_residual`` (wi_gate, wi_up (d, f), wo (f, d))."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        E, d, f, pd = cfg.moe_experts, cfg.d_model, cfg.d_ff, cfg.pdtype
        self.router = _param((d, E), torch.float32, device)
        self.wi_gate = _param((E, d, f), pd, device)
        self.wi_up = _param((E, d, f), pd, device)
        self.wo = _param((E, f, d), pd, device)
        self.dense_residual = nn.ParameterDict({
            n: _param(s, pd, device) for n, s in (
                ("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}) \
            if cfg.moe_dense_residual else None


@torch.no_grad()
def init_moe(p: MoE, cfg: ModelConfig, generator: torch.Generator) -> None:
    """Random weights at the reference's scales, drawn in place in each
    tensor's own dtype: the router and the expert inputs × d^-½, the
    expert outputs × f^-½ (the fan-in, not the expert axis), the dense
    residual × its fan-in^-½."""
    d, f = cfg.d_model, cfg.d_ff
    for t, fan_in in ((p.router, d), (p.wi_gate, d), (p.wi_up, d),
                      (p.wo, f)):
        t.normal_(generator=generator).mul_(fan_in ** -0.5)
    if p.dense_residual is not None:
        for t in p.dense_residual.values():
            t.normal_(generator=generator).mul_(t.shape[0] ** -0.5)


def _route(p: MoE, xg: torch.Tensor, cfg: ModelConfig, C: int):
    """Router and FIFO positions of one batch of groups xg (G, g, d):
    (probs (G, g, E) float32, gates (G, g, k) float32, expert index
    (G, g, k), position in the expert (G, g, k), kept (G, g, k), the
    choices one-hot (G, g·k, E))."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    G, g, _ = xg.shape
    logits = torch.matmul(xg.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: the larger first, the lower index first on ties
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # one-hot by scatter (F.one_hot reads the values to check them)
    sel = torch.zeros((G, g * k, E), dtype=torch.long, device=xg.device)
    sel.scatter_(2, idx.reshape(G, g * k, 1), 1)
    # tokens before this (token, choice) in its expert, token-major
    before = torch.cumsum(sel, dim=1) - sel
    pos = before.gather(-1, idx.reshape(G, g * k, 1)).reshape(G, g, k)
    return probs, gates, idx, pos, pos < C, sel


def _dispatch(xz: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor,
              keep: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The experts' inputs (E, G·C, d) from the groups xz (G, g, d): slot
    (e, group, c) holds the token whose kept choice sits at position c of
    expert e, or zeros — the reference's ``expert_in`` (GEcd), experts
    first.  Dropped choices land on a spare slot that nobody reads."""
    G, g, d = xz.shape
    k, dev = idx.shape[-1], xz.device
    slot = torch.where(keep, idx * C + pos, E * C).reshape(G, g * k)
    owner = torch.full((G, E * C + 1), g, dtype=torch.long, device=dev)
    owner.scatter_(1, slot, torch.arange(g, device=dev).repeat_interleave(
        k).expand(G, -1))
    # row g of each group is zeros: the source of an empty slot
    rows = owner[:, :E * C] + torch.arange(G, device=dev)[:, None] * (g + 1)
    rows = rows.reshape(G, E, C).transpose(0, 1).reshape(E, G * C)
    return F.pad(xz, (0, 0, 0, 1)).reshape(G * (g + 1), d)[rows]


def moe_ffn(p: MoE, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d) in x's dtype, aux loss float32)."""
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    tokens = B * S
    g, G, C = capacity(cfg, tokens)
    dt, dev = x.dtype, x.device
    # the last group zero-padded to g rows
    xz = F.pad(x.reshape(tokens, d), (0, 0, 0, G * g - tokens)) \
        .reshape(G, g, d)
    probs, gates, idx, pos, keep, sel = _route(p, xz, cfg, C)
    expert_in = _dispatch(xz, idx, pos, keep, E, C)
    h = F.silu(torch.bmm(expert_in, p.wi_gate.to(dt))) \
        * torch.bmm(expert_in, p.wi_up.to(dt))
    out_e = torch.bmm(h, p.wo.to(dt)).reshape(E * G * C, d)
    out_e = F.pad(out_e, (0, 0, 0, 1))                   # a zero row

    # combine: Σ over a token's kept choices of gate · its expert's output
    at = idx * (G * C) + torch.arange(G, device=dev)[:, None, None] * C + pos
    at = torch.where(keep, at, E * G * C).reshape(G * g, k)
    w = (gates.to(dt).float() * keep).reshape(G * g, 1, k)
    y = torch.bmm(w, out_e[at].float()).to(dt)          # (G·g, 1, d)
    y = y.reshape(G * g, d)[:tokens].reshape(B, S, d)
    if p.dense_residual is not None:
        y = y + mlp(p.dense_residual, x, "swiglu")

    # Switch-style load-balance aux loss over every row of every group
    me = probs.mean(dim=1)                               # (G, E)
    ce = sel.sum(dim=1).float() / g                      # (G, E)
    aux = (E / k) * (me * ce).sum(-1).mean()
    return y.to(x.dtype), aux
