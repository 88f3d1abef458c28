"""Device policy for the port's kernels — the counterpart of
``repro.kernels.dispatch`` (``resolve_flags`` / ``plan_edge_kernel``) and
of the model layer's ``attention_impl="pallas"`` route
(``repro.kernels.ops.flash_attention``).

The rule is the tensors' device, nothing else:

* a CUDA tensor goes to the CUDA C++ kernel (:mod:`.edge_latency`,
  :mod:`.flash_attention`, :mod:`.rmsnorm`, :mod:`.ssd_scan`);
* a CPU tensor goes to the plain PyTorch version (:mod:`.ref`);
* any other device, or operands on different devices, raise.

There is no coercion and no fallback: a CUDA tensor reaches the kernel or
raises.  Gradients follow the same rule.  On the card K7 and K6 have a
backward (:class:`~repro_torch.kernels.rmsnorm.RMSNormFunction`,
:class:`~repro_torch.kernels.ssd_scan.SSDScanFunction`, taken when grad
mode is on and an operand requires grad; K6's final state is not
differentiated, and asking for it under grad raises); every other card
route raises in that case instead of returning a tensor without a
``grad_fn``, giving the reason (:data:`NO_BACKWARD`).  The plain routes on
the CPU are ordinary autograd, as the reference trains through its plain
functions.  K1's and K2's launch config on the card comes from the block
policy (:func:`edge_config`: :func:`repro_torch.kernels.autotune.get_config`
unless the caller pins one with ``config=``, as the reference's
``plan_edge_kernel`` consults its autotuner unless the caller pins
blocks); the plain routes take none, and a pinned config that K1 / K2 were
not built for raises on either route.  The other kernels' block sizes are
constants of their sources.  Every decision is counted as
``kernels.dispatch.plans{kind, impl}`` in :mod:`repro_torch.obs` when the
registry is enabled (kind ``dense``,
``structured``, ``dense_single_tile``, ``structured_single_tile``,
``flash_attention``, ``rmsnorm`` or ``ssd_scan``), and each route runs
inside ``repro_torch.perf.counts.kernel_scope`` of its kernel's name, so an
open counter splits its count by kernel.

The single-tile routes (K4a, K4b) are the whole-V references the blocked
kernels are held against; as in the reference, no path of the system
reaches them.

Sharded operands (DTensors, the mesh planner's route) are taken to their
local shards at the boundary: the kernel, or its plain version, runs on
each device's shard and the result comes back as a DTensor with the
operand's placements (:func:`_on_local_shards`).  K7 needs whole rows, so
its last dim must not be split; K5 takes q, k and v split alike over rows
and heads only (a replicated k hands each ``model`` rank the kv heads of
its own query heads); K6 takes x, dt, A and D split over heads (whole
heads only: a split of the head dim, or of a head count that the ways do
not divide, is refused before launch) and rows, B and C split over rows
and replicated over the heads' devices.  Gradients cross the
boundary with the placements they have: an operand's own, and partial
sums for an operand replicated over devices that split the work (K7's dw,
K6's B and C over heads, A and D over rows).

:func:`resolve_device` is the policy for the public entry points
(``BatchedEvaluator``, ``WhatIfService``, ``build_model``): ``None`` means
the card, and a machine without CUDA raises instead of quietly running on
the CPU.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.perf.counts import kernel_scope
from repro_torch.kernels import autotune
from repro_torch.kernels import edge_latency as kernels
from repro_torch.kernels import flash_attention as attention_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.kernels import ssd_scan as ssd_kernel

__all__ = ["resolve_device", "plan_edge_kernel", "plan_attention_kernel",
           "edge_config", "edge_latency", "edge_latency_structured",
           "edge_latency_single_tile", "edge_latency_structured_single_tile",
           "flash_attention", "rmsnorm", "ssd_scan"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device.  Raises RuntimeError when CUDA is
    asked for (explicitly or by default) and unavailable; the CPU is used
    only when the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _plan(kind: str, what: str, tensors) -> str:
    """"cuda" or "plain" for these operands (see the module docstring)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kind} {what} operands span devices "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        impl = "cuda"
    elif dev.type == "cpu":
        impl = "plain"
    else:
        raise ValueError(f"no {what} route for device {dev}")
    reg = obs.registry()
    if reg.enabled:
        reg.counter("kernels.dispatch.plans", kind=kind, impl=impl).add(1)
    return impl


# why each card route without a backward has none
NO_BACKWARD = {
    "flash_attention": "the reference's Pallas kernel has no gradient either "
                       "(ROADMAP B2, decided against): train with "
                       "attention_impl='reference', as the reference must",
    "edge_latency": "none: the reference never differentiates it, A9 "
                    "differentiates the smoothed model instead (ROADMAP A9)",
}


def _refuse_grad(kind: str, item: str, tensors) -> None:
    """Raise when the card route ``kind`` would cut a gradient: grad mode
    on and an operand requiring grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kind}: the CUDA kernel has no backward and would return a "
            f"tensor without a grad_fn ({NO_BACKWARD[item]}); run under "
            f"torch.no_grad() or on the CPU route")


def plan_edge_kernel(kind: str, *tensors: torch.Tensor) -> str:
    """"cuda" or "plain" for edge-latency operands of ``kind`` ("dense",
    "structured", "dense_single_tile" or "structured_single_tile"); the
    card route raises under grad (no backward)."""
    impl = _plan(kind, "edge-latency", tensors)
    if impl == "cuda":
        _refuse_grad(kind, "edge_latency", tensors)
    return impl


def plan_attention_kernel(*tensors: torch.Tensor) -> str:
    """"cuda" or "plain" for attention operands; the card route raises
    under grad (K5 has no backward)."""
    impl = _plan("flash_attention", "flash-attention", tensors)
    if impl == "cuda":
        _refuse_grad("flash_attention", "flash_attention", tensors)
    return impl


def edge_config(kind: str, B: int, E: int, V: int, R: int | None = None,
                com_batch: int = 1, config=None):
    """K1's (``kind="dense"``) or K2's launch config on the card: ``config``
    when the caller pins one, else the block policy's choice for the shape
    (:func:`repro_torch.kernels.autotune.get_config`, keyed ``"cuda"``).  A
    pinned config that was not instantiated, or whose shared memory does
    not fit at this R, raises ValueError — it is never replaced by
    another."""
    if config is not None:
        check = kernels.dense_config if kind == "dense" \
            else kernels.structured_config
        check(config)
        if E > 0:                    # K2's mass tile must fit at this R
            kernels.block_geometry(kind, E, V, R, config, B=B,
                                   com_batch=com_batch)
        return config
    if E == 0:                       # nothing to launch
        return autotune.DEFAULT_CONFIG
    return autotune.get_config(kind, B, E, V, R, com_batch=com_batch,
                               backend="cuda")


def edge_latency(x_i, x_j, com, *, config=None) -> torch.Tensor:
    """Dense edge-latency max: (B, E, V) rows × (B|1, V, V) com → (B, E);
    on the card at the block policy's config, or ``config`` if pinned."""
    with kernel_scope("edge_latency_dense"):
        B, E, V = x_i.shape
        if plan_edge_kernel("dense", x_i, x_j, com) == "cuda":
            cfg = edge_config("dense", B, E, V, com_batch=com.shape[0],
                              config=config)
            return kernels.edge_latency_dense(x_i, x_j, com, config=cfg)
        if config is not None:
            kernels.dense_config(config)
        return ref.edge_latency_dense_plain(x_i, x_j, com)


def edge_latency_structured(x_i, x_j, mass, a, corr, *,
                            config=None) -> torch.Tensor:
    """Structured (RegionFleet) edge-latency max:
    ``max_u x_i·(mass @ a + corr·x_j)`` → (B, E); on the card at the block
    policy's config, or ``config`` if pinned."""
    with kernel_scope("edge_latency_structured"):
        B, E, V = x_i.shape
        if plan_edge_kernel("structured", x_i, x_j, mass, a, corr) == "cuda":
            cfg = edge_config("structured", B, E, V, mass.shape[-1],
                              com_batch=a.shape[0], config=config)
            return kernels.edge_latency_structured(x_i, x_j, mass, a, corr,
                                                   config=cfg)
        if config is not None:
            kernels.structured_config(config)
        return ref.edge_latency_structured_plain(x_i, x_j, mass, a, corr)


def edge_latency_single_tile(x_i, x_j, com) -> torch.Tensor:
    """K1's function through the whole-V kernel (K4a) on the card, its
    plain version on the CPU."""
    with kernel_scope("edge_latency_dense_single_tile"):
        if plan_edge_kernel("dense_single_tile", x_i, x_j, com) == "cuda":
            return kernels.edge_latency_dense_single_tile(x_i, x_j, com)
        return ref.edge_latency_dense_single_tile_plain(x_i, x_j, com)


def edge_latency_structured_single_tile(x_i, x_j, mass, a,
                                        corr) -> torch.Tensor:
    """K2's function through the whole-V kernel (K4b) on the card, its
    plain version on the CPU."""
    with kernel_scope("edge_latency_structured_single_tile"):
        if plan_edge_kernel("structured_single_tile", x_i, x_j, mass, a,
                            corr) == "cuda":
            return kernels.edge_latency_structured_single_tile(
                x_i, x_j, mass, a, corr)
        return ref.edge_latency_structured_single_tile_plain(x_i, x_j, mass,
                                                             a, corr)


def _is_dtensor(*tensors) -> bool:
    return any(type(t).__name__ == "DTensor" for t in tensors)


def _on_local_shards(fn, x, others, grads):
    """``fn(x_local, *others_local)`` as a DTensor with ``x``'s placements.
    ``others`` are DTensors already in the layout ``fn`` needs; ``grads``
    gives each operand's gradient placements (x first)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import to_local
    local = [to_local(t, g) for t, g in zip((x, *others), grads)]
    out = fn(*local).contiguous()
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _replicated(x, mesh):
    """``x`` as a DTensor replicated over ``mesh`` (a plain tensor is taken
    to be the same on every device)."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = (Replicate(),) * mesh.ndim
    if not _is_dtensor(x):
        return DTensor.from_local(x, mesh, rep, run_check=False)
    return x if tuple(x.placements) == rep else x.redistribute(mesh, rep)


def _sharded_rmsnorm(x, w, eps: float):
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.models.sharding import settle
    x = settle(x)
    if any(p.is_shard(x.dim() - 1) for p in x.placements):
        raise ValueError(f"rmsnorm: the normalized dim of a {tuple(x.shape)} "
                         f"operand is split ({x.placements}); K7 needs "
                         f"whole rows (the 'embed' rule must replicate)")
    w = _replicated(w, x.device_mesh)
    dw = tuple(Partial() if p.is_shard() else Replicate()
               for p in x.placements)
    return _on_local_shards(lambda xl, wl: rmsnorm(xl, wl, eps), x, (w,),
                            (x.placements, dw))


def _sharded_flash_attention(q, k, v, causal: bool):
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    # attention is independent per row and per head: any other split
    # (the sequence, the head dim, a partial sum) is gathered
    pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in q.placements)
    q, k, v = (t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
               for t in (q, k, v))
    return _on_local_shards(
        lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal), q,
        (k, v), (q.placements,) * 3)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention with kv repeated to H → (B, S, H, D) in q's
    dtype: K5 on the card, its plain version on the CPU; DTensor operands
    on their local shards."""
    if _is_dtensor(q, k, v):
        return _sharded_flash_attention(q, k, v, causal)
    with kernel_scope("flash_attention"):
        if plan_attention_kernel(q, k, v) == "cuda":
            return attention_kernel.flash_attention(q, k, v, causal=causal)
        return ref.flash_attention_plain(q, k, v, causal=causal)


def rmsnorm(x, w, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the last axis with a weight, in x's dtype: K7 on the
    card, its plain version on the CPU.  The weight is read as float32.
    Under grad (grad mode on, x or w requiring grad) the card route is
    K7's autograd function: the forward kernel, and K7's backward kernel
    for the gradient.  A DTensor operand runs on its local shards."""
    if _is_dtensor(x, w):
        return _sharded_rmsnorm(x, w, eps)
    with kernel_scope("rmsnorm"):
        if _plan("rmsnorm", "rmsnorm", (x, w)) == "cuda":
            if torch.is_grad_enabled() and (x.requires_grad
                                            or w.requires_grad):
                return rmsnorm_kernel.rmsnorm_autograd(x, w.float(), eps)
            return rmsnorm_kernel.rmsnorm(x, w.float(), eps)
        return ref.rmsnorm_plain(x, w, eps)


def _sharded_ssd_scan(x, B, C, dt, A, D, chunk: int, final_state: bool,
                      state_out):
    """K6 on the local shards: each device scans its rows and its heads.
    x (b, L, H, P) keeps its split of rows (dim 0) and heads (dim 2), a
    split of L is gathered (the scan runs over the whole sequence), and a
    split of P or of a head count that the ways do not divide raises
    before launch.  dt follows x, A and D (H,) its heads, B and C (b, L, N)
    its rows; y comes back laid out as x, the final state (b, H, N, P)
    split as x's rows and heads, and a DTensor ``state_out`` must already
    be laid out so (its local shard is written in place)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.sharding import settle, to_local
    x = settle(x)
    mesh = x.device_mesh
    H = x.shape[2]
    for p, n in zip(x.placements, mesh.shape):
        if p.is_shard(3) or (p.is_shard(2) and n > 1 and H % n):
            raise ValueError(
                f"ssd_scan: a {tuple(x.shape)} operand split {x.placements} "
                f"on mesh {tuple(mesh.shape)} cuts a head; K6 takes whole "
                f"heads (the 'heads' rule must divide d_inner / P)")
    heads = tuple(p.is_shard(2) for p in x.placements)
    rows = tuple(p.is_shard(0) for p in x.placements)
    ways = 1
    for h, n in zip(heads, mesh.shape):
        ways *= n if h else 1
    if H % ways:
        raise ValueError(f"ssd_scan: {H} heads do not split {ways} ways")

    def lay(per_rows, per_heads, other=Replicate()):
        return tuple(per_rows if r else per_heads if h else other
                     for r, h in zip(rows, heads))

    x_pl = lay(Shard(0), Shard(2))
    want = {"x": x_pl, "dt": x_pl, "A": lay(Replicate(), Shard(0)),
            "D": lay(Replicate(), Shard(0)),
            "B": lay(Shard(0), Replicate()), "C": lay(Shard(0), Replicate())}
    grads = {"x": x_pl, "dt": x_pl, "A": lay(Partial(), Shard(0)),
             "D": lay(Partial(), Shard(0)), "B": lay(Shard(0), Partial()),
             "C": lay(Shard(0), Partial())}
    ops = dict(x=x, B=B, C=C, dt=dt, A=A, D=D)
    local = {}
    for name, t in ops.items():
        t = _replicated(t, mesh) if not _is_dtensor(t) else settle(t)
        if tuple(t.placements) != want[name]:
            t = t.redistribute(mesh, want[name])
        ops[name] = t
        local[name] = to_local(t, grads[name])
    state_pl = lay(Shard(0), Shard(1))
    into = {}
    if state_out is not None:
        if not _is_dtensor(state_out) \
                or tuple(state_out.placements) != state_pl:
            raise ValueError(
                f"ssd_scan: state_out must be a DTensor laid out "
                f"{state_pl}, got {getattr(state_out, 'placements', None)}")
        into = {"state_out": state_out.to_local()}
    x = ops["x"]
    out = ssd_scan(local["x"], local["B"], local["C"], local["dt"],
                   local["A"], local["D"], chunk, final_state, **into)
    y, S = out if isinstance(out, tuple) else (out, None)
    y = DTensor.from_local(y.contiguous(), mesh, x_pl, run_check=False,
                           shape=x.shape, stride=x.stride())
    if S is None:
        return y
    if state_out is not None:
        return y, state_out
    b, _, _, P = x.shape
    N = ops["B"].shape[-1]
    shape = (b, H, N, P)
    return y, DTensor.from_local(S, mesh, state_pl, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=torch.empty(shape,
                                                    device="meta").stride())


def ssd_scan(x, B, C, dt, A, D, chunk: int, final_state: bool = False,
             state_out=None):
    """The Mamba2 SSD chunked scan → y (b, L, H, P) in x's dtype, or
    (y, final state (b, H, N, P) float32) with ``final_state`` or a
    ``state_out`` to write it into: K6 on the card, its plain version on
    the CPU.  Under grad (grad mode on, an operand requiring grad) the
    card route is K6's autograd function, the forward kernel and K6's
    backward kernels for the gradient; the final state is not
    differentiated there, so asking for it raises.  DTensor operands run
    on their local shards (:func:`_sharded_ssd_scan`)."""
    if _is_dtensor(x, B, C, dt, A, D):
        return _sharded_ssd_scan(x, B, C, dt, A, D, chunk, final_state,
                                 state_out)
    into = {} if state_out is None else {"state_out": state_out}
    with kernel_scope("ssd_scan"):
        if _plan("ssd_scan", "SSD-scan", (x, B, C, dt, A, D)) == "cuda":
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (x, B, C, dt, A, D)):
                if final_state or state_out is not None:
                    raise RuntimeError(
                        "ssd_scan: the final state (the prefill's cache) is "
                        "not differentiated on the card: no training path "
                        "differentiates it; run the prefill under "
                        "torch.no_grad()")
                return ssd_kernel.SSDScanFunction.apply(x, B, C, dt, A, D,
                                                        chunk)
            return ssd_kernel.ssd_scan(x, B, C, dt, A, D, chunk, final_state,
                                       **into)
        return ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, final_state,
                                  **into)
