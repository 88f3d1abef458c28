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

Sharding: :func:`expert_axes` and :func:`moe_specs` are the reference's
``_expert_axes`` and ``moe_specs``: experts over ``model`` where E divides
it (the FFN dim over ``model`` where it does not), or, with the
``experts`` rule on a batch axis (the expert-parallel-over-data variant,
``moe_ep=data``), E over that axis and d_ff over ``model``.  A DTensor
input takes :func:`_sharded_moe_ffn`: routing and dispatch run on each
device's rows (groups follow the data shards, as the reference's
``shard(xg, "batch", …)``: a device holding no whole number of groups
routes the gathered batch), the (E, G·C, d) buffer is the all-to-all
boundary — split on the experts' axis, and on the batch axes over G
unless the experts take a batch axis, which the group dim then releases
(``moe.py:137-157``) — the expert GEMMs are DTensor ``bmm`` against the
experts' split, and the outputs go back to their rows' devices for the
combine.  Where the experts take a batch axis the buffer crosses it by an
explicit ``all_to_all_single`` over that mesh dim, out and back (each
device sends each expert block its rows; DTensor's own move from the row
split to the expert split is an all-gather on a CPU mesh); over an axis
that holds the rows whole (experts over ``model``) the split is a local
slice and the way back an all-gather.  The aux loss sums each device's
groups and reduces the sum over the batch axes.  On a mesh of one device
every op is the unsharded one.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.api import ModelConfig
from repro_torch.models.layers import mlp
from repro_torch.models.sharding import (P, active_mesh, axis_rules,
                                         gather_inner, mesh_axes, param_spec,
                                         settle, to_local)

__all__ = ["MoE", "capacity", "moe_ffn", "init_moe", "expert_axes",
           "moe_specs"]


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


def expert_axes(cfg: ModelConfig):
    """(the mesh axes the experts split over or None, whether d_ff splits
    over ``model`` too): the reference's ``_expert_axes``."""
    mesh = active_mesh()
    sizes = mesh_axes(mesh) if mesh is not None else {}
    target = axis_rules().rules.get("experts")
    axes = (target,) if isinstance(target, str) else (target or ())
    axes = tuple(a for a in axes if a in sizes)
    ways = 1
    for a in axes:
        ways *= sizes[a]
    if axes and cfg.moe_experts % ways == 0:
        ff_axis = axis_rules().rules.get("ff")
        shard_ff = (ff_axis in sizes) and (ff_axis not in axes) \
            and cfg.d_ff % sizes.get(ff_axis, 1) == 0
        return axes, shard_ff
    return None, False


def moe_specs(cfg: ModelConfig) -> dict[str, P]:
    """The reference's ``moe_specs(stacked=False)``, keyed like
    :class:`MoE`'s ``named_parameters()``."""
    e_axes, shard_ff = expert_axes(cfg)
    if e_axes is not None:
        e = e_axes if len(e_axes) > 1 else e_axes[0]
        f = "model" if shard_ff else None
        w_spec, wo_spec = P(e, None, f), P(e, f, None)
    else:
        w_spec = param_spec((None, None, "ff"))
        wo_spec = param_spec((None, "ff", None))
    specs = {"router": param_spec((None, None)), "wi_gate": w_spec,
             "wi_up": w_spec, "wo": wo_spec}
    if cfg.moe_dense_residual:
        specs.update({"dense_residual.wi_gate": param_spec((None, "ff")),
                      "dense_residual.wi_up": param_spec((None, "ff")),
                      "dense_residual.wo": param_spec(("ff", None))})
    return specs


def _route(p, xg: torch.Tensor, cfg: ModelConfig, C: int):
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


def _experts(p, expert_in: torch.Tensor) -> torch.Tensor:
    """The expert GEMMs on (E, rows, d) in its dtype → (E, rows, d)."""
    dt = expert_in.dtype
    h = F.silu(torch.bmm(expert_in, p.wi_gate.to(dt))) \
        * torch.bmm(expert_in, p.wi_up.to(dt))
    return torch.bmm(h, p.wo.to(dt))


def _combine(out_e: torch.Tensor, gates, idx, pos, keep,
             C: int) -> torch.Tensor:
    """(G·g, d) in out_e's dtype: each token's kept choices' expert
    outputs (out_e (E, G·C, d)) weighted by their gates, summed in
    float32."""
    G, g, k = idx.shape
    E, _, d = out_e.shape
    dt, dev = out_e.dtype, out_e.device
    out_e = F.pad(out_e.reshape(E * G * C, d), (0, 0, 0, 1))  # a zero row
    at = idx * (G * C) + torch.arange(G, device=dev)[:, None, None] * C + pos
    at = torch.where(keep, at, E * G * C).reshape(G * g, k)
    w = (gates.to(dt).float() * keep).reshape(G * g, 1, k)
    return torch.bmm(w, out_e[at].float()).to(dt).reshape(G * g, d)


def _aux_terms(probs: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Per group Σ_e (mean router prob · choices per token) → (G,)."""
    me = probs.mean(dim=1)                               # (G, E)
    ce = sel.sum(dim=1).float() / probs.shape[1]         # (G, E)
    return (me * ce).sum(-1)


def moe_ffn(p: MoE, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d) in x's dtype, aux loss float32); ``p``
    is an :class:`MoE` or any object with its weights as attributes.  A
    DTensor ``x`` takes :func:`_sharded_moe_ffn`."""
    if hasattr(x, "placements"):
        return _sharded_moe_ffn(p, x, cfg)
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    tokens = B * S
    g, G, C = capacity(cfg, tokens)
    # the last group zero-padded to g rows
    xz = F.pad(x.reshape(tokens, d), (0, 0, 0, G * g - tokens)) \
        .reshape(G, g, d)
    probs, gates, idx, pos, keep, sel = _route(p, xz, cfg, C)
    out_e = _experts(p, _dispatch(xz, idx, pos, keep, E, C))
    y = _combine(out_e, gates, idx, pos, keep, C)
    y = y[:tokens].reshape(B, S, d)
    if p.dense_residual is not None:
        y = y + mlp(p.dense_residual, x, "swiglu")
    # Switch-style load-balance aux loss over every row of every group
    aux = (E / k) * _aux_terms(probs, sel).mean()
    return y.to(x.dtype), aux


def _all_to_all(buf, dim: int, placements, to_experts: bool):
    """The (E, rows, d) DTensor ``buf`` across mesh dim ``dim`` (n devices)
    by one ``all_to_all_single``, laid out as ``placements`` after it:
    with ``to_experts`` each device's rows of every expert → its E/n
    experts' rows from every device (rows split on ``dim`` → experts split
    on it), else back."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    mesh = buf.device_mesh
    n = mesh.size(dim)
    local = to_local(buf)
    e, r, d = local.shape
    if not to_experts:          # each device's rows, blocks to their owners
        local = local.reshape(e, n, r // n, d).transpose(0, 1) \
            .reshape(n * e, r // n, d)
    out = funcol.all_to_all_single(local.contiguous(), None, None,
                                   mesh.get_group(dim))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    if to_experts:              # device j's rows at position j
        out = out.reshape(n, e // n, r, d).transpose(0, 1) \
            .reshape(e // n, n * r, d)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=buf.shape, stride=buf.stride())


def _sharded_moe_ffn(p, x, cfg: ModelConfig):
    """:func:`moe_ffn` on a DTensor x (B, S, d) whose rows are split over
    the batch axes (see the module docstring); the weights are DTensors
    in :func:`moe_specs`' layout.  Returns (y laid out as x's rows, the
    aux loss replicated)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels.dispatch import _replicated
    mesh = x.device_mesh
    x = settle(gather_inner(x))
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    g, G, C = capacity(cfg, B * S)
    rows = [pl.is_shard(0) for pl in x.placements]
    ways = 1
    for r, n in zip(rows, mesh.shape):
        ways *= n if r else 1
    if B % ways or (B // ways * S) % g:     # no whole groups a device
        rows, ways = [False] * mesh.ndim, 1

    def lay(on_rows, other=Replicate()):
        return tuple(on_rows if r else other for r in rows)

    if tuple(x.placements) != lay(Shard(0)):
        x = x.redistribute(mesh, lay(Shard(0)))
    xl = to_local(x)
    tokens, G_l = xl.shape[0] * S, G // ways
    xz = F.pad(xl.reshape(tokens, d), (0, 0, 0, G_l * g - tokens)) \
        .reshape(G_l, g, d)
    router = to_local(_replicated(p.router, mesh), lay(Partial()))
    probs, gates, idx, pos, keep, sel = _route(
        types.SimpleNamespace(router=router), xz, cfg, C)
    owners = lay(Shard(1))                  # (E, G·C, d) on the rows' devices
    ein = DTensor.from_local(_dispatch(xz, idx, pos, keep, E, C), mesh,
                             owners, run_check=False,
                             shape=torch.Size((E, G * C, d)),
                             stride=(G * C * d, d, 1))
    # the all-to-all boundary: the experts' split; the group dim releases
    # a batch axis that the experts take
    e_axes, _ = expert_axes(cfg)
    moved = None
    if e_axes is not None:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in e_axes]
        taken = [i for i in dims if rows[i]]
        if taken and (len(taken) > 1 or taken[0] != min(dims)):
            raise ValueError(
                f"experts over {e_axes}: only the first of the experts' "
                f"mesh axes may hold rows (rows over "
                f"{[n for n, r in zip(names, rows) if r]})")
        moved = taken[0] if taken else None

        def alone(pl):      # split on the moved axis only
            return tuple(pl if i == moved else Replicate()
                         for i in range(mesh.ndim))

        target = tuple(Shard(0) if i in dims
                       else Replicate() if taken else pl
                       for i, pl in enumerate(owners))
        if moved is not None:
            # the other batch axes released, then the tokens to their
            # experts, then any later experts' axis sliced
            ein = _all_to_all(ein.redistribute(mesh, alone(Shard(1))),
                              moved, alone(Shard(0)), to_experts=True)
        ein = ein.redistribute(mesh, target)
    out_e = settle(_experts(p, ein))
    if moved is not None:
        out_e = _all_to_all(out_e.redistribute(mesh, alone(Shard(0))),
                            moved, alone(Shard(1)), to_experts=False)
    if tuple(out_e.placements) != owners:
        out_e = out_e.redistribute(mesh, owners)
    y = _combine(to_local(out_e), gates, idx, pos, keep, C)
    y = DTensor.from_local(y[:tokens].reshape(xl.shape), mesh, x.placements,
                           run_check=False, shape=x.shape, stride=x.stride())
    if p.dense_residual is not None:
        y = y + mlp(p.dense_residual, x, "swiglu")
    terms = _aux_terms(probs, sel)
    if ways == 1:
        aux = DTensor.from_local((E / k) * terms.mean(), mesh,
                                 (Replicate(),) * mesh.ndim, run_check=False)
    else:       # each device's groups, summed over the batch axes
        aux = (E / k) * settle(DTensor.from_local(
            terms.sum(), mesh, lay(Partial()), run_check=False)) / G
    return y.to(x.dtype), aux
