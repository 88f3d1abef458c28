"""Logical-axis sharding — the counterpart of ``repro.models.sharding``.

Model code names axes ("batch", "vocab", "heads", "ff", …); an
:class:`AxisRules` maps them to mesh axes and is swappable per experiment
without touching model code.  A spec is the reference's ``PartitionSpec``:
a tuple (:class:`P`) with one entry per tensor dim, each ``None``
(replicated), a mesh-axis name, or a tuple of names.  :func:`placements`
turns a spec into DTensor placements on a ``DeviceMesh``: ``Shard(d)`` on
every mesh dim named in entry ``d`` and ``Replicate()`` on the others.

The mesh-reading functions (:meth:`AxisRules.resolve`, :func:`param_spec`,
:func:`fsdp_leaf_spec`) read only a mesh's axis names and sizes
(:func:`mesh_axes`): a ``DeviceMesh`` or any object with ``axis_names``
and ``shape`` (a mapping, as a JAX mesh has, or a tuple) serves.

The ambient mesh is the one :func:`repro_torch.launch.mesh.use_mesh`
installs.  Without one everything is a no-op, so the same model code runs
on one device.  With one, :func:`shard` redistributes a DTensor to the
spec (the reference's ``with_sharding_constraint``); a plain tensor passes
through unchanged.

The port keeps one module per layer where the reference stacks the
layers on a leading axis.  So a per-layer leaf here is the reference's
stacked leaf without its layer entry, and :func:`fsdp_leaf_spec` takes
``layers`` to size a leaf as the reference's stacked one
(``FSDP_MIN_ELEMS`` applies to ``layers · numel``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping

import torch

__all__ = ["P", "AxisRules", "DEFAULT_RULES", "axis_rules", "set_axis_rules",
           "rules_override", "logical_spec", "shard", "shard_div",
           "param_spec", "fsdp_leaf_spec", "constrain_tree", "mesh_axes",
           "active_mesh", "placements", "distribute",
           "settle", "whole_last", "write_into", "gather_inner",
           "gather_inner_grad", "keep_grad_layout", "to_local",
           "block_weights",
           "subtree",
           "plain", "FSDP_AXIS", "FSDP_MIN_ELEMS"]

MeshAxes = tuple[str, ...] | str | None


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``;
    equal to the tuple of its entries (a JAX ``PartitionSpec``'s
    ``tuple()``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name → size of ``mesh``: a ``DeviceMesh`` (``mesh_dim_names``)
    or an object with ``axis_names`` and ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.axis_names, shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name → mesh axis (or tuple, or None = replicate)."""

    rules: dict[str, MeshAxes]

    def resolve(self, *logical: str | None, mesh=None) -> P:
        """The spec for the given logical axes, dropping mesh axes that the
        active mesh lacks (so ("pod", "data") batch rules work on one-pod
        meshes too)."""
        mesh = mesh if mesh is not None else active_mesh()
        present = set(mesh_axes(mesh)) if mesh is not None else set()
        out = []
        for name in logical:
            target = self.rules.get(name) if name else None
            if target is None:
                out.append(None)
                continue
            if isinstance(target, str):
                target = (target,)
            kept = tuple(a for a in target if a in present)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        return P(*out)


DEFAULT_RULES = AxisRules({
    # activations
    "batch": ("pod", "data"),
    "seq": None,          # flip to "model" for sequence parallelism
    "embed": None,
    # params
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",   # replicated automatically when not divisible
    "ff": "model",
    "experts": "model",
    "inner": "model",      # mamba2 d_inner / conv channels
    "state": None,
    "layers": None,
})

_local = threading.local()


def set_axis_rules(rules: AxisRules) -> None:
    _local.rules = rules


def axis_rules() -> AxisRules:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def rules_override(**changes: MeshAxes):
    """The current rules with ``changes`` inside the block, restored after
    it."""
    saved = axis_rules()
    set_axis_rules(AxisRules({**saved.rules, **changes}))
    try:
        yield axis_rules()
    finally:
        set_axis_rules(saved)


def active_mesh():
    """The mesh :func:`repro_torch.launch.mesh.use_mesh` installed in this
    thread, or None."""
    return getattr(_local, "mesh", None)


def _set_active_mesh(mesh) -> None:
    _local.mesh = mesh


def logical_spec(*logical: str | None) -> P:
    return axis_rules().resolve(*logical)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dim that entry ``d`` names, ``Replicate()``
    on the others.  An entry naming several mesh dims shards its tensor
    dim over them major to minor, which DTensor expresses only in mesh
    order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} shards dim {d} over "
                             f"mesh axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(x, spec, mesh):
    """The plain tensor ``x`` — the same full tensor on every device — as
    a DTensor laid out by ``spec`` on ``mesh``: each device keeps its own
    chunk (``torch.chunk`` along each split dim, mesh dims in order, as
    DTensor's ``Shard``), with no communication.  Works on fake tensors."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    coord = mesh.get_coordinate()
    local = x
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            pieces = torch.chunk(local, n, dim=p.dim)
            local = pieces[coord[i]] if coord[i] < len(pieces) \
                else local.narrow(p.dim, 0, 0)
    if local is not x:      # each device owns its chunk, not a view
        local = local.contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def settle(x):
    """A DTensor with each partial placement reduced (replicated)."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def whole_last(x):
    """A DTensor with its last dim gathered where it is split (a kernel
    that needs whole rows, a concatenation along it); any other value as
    it is."""
    pl = getattr(x, "placements", None)
    if pl is None:
        return x
    from torch.distributed.tensor import Replicate
    last = x.dim() - 1
    new = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    return x if new == tuple(pl) else x.redistribute(x.device_mesh, new)


def write_into(dst, src) -> None:
    """``dst.copy_(src)`` where ``dst`` may be a DTensor in another layout
    than ``src`` (a cache slice): ``src`` is laid out as ``dst`` first, so
    each device writes its own shard."""
    pl = getattr(dst, "placements", None)
    if pl is not None and tuple(src.placements) != tuple(pl):
        src = src.redistribute(dst.device_mesh, pl)
    dst.copy_(src)


def gather_inner(x):
    """A DTensor with every dim between its first and its last gathered
    (sequence-parallel activations entering a matmul: DTensor cannot
    flatten rows split on two dims); any other value as it is."""
    pl = getattr(x, "placements", None)
    if pl is None or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate
    inner = range(1, x.dim() - 1)
    new = tuple(Replicate() if any(p.is_shard(d) for d in inner) else p
                for p in pl)
    return x if new == tuple(pl) else x.redistribute(x.device_mesh, new)


class _InnerGradGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def gather_inner_grad(y):
    """Identity whose backward gathers the gradient's inner dims, as
    :func:`gather_inner` does the forward's (a matmul's output gradient
    arriving sequence-split); any other value as it is."""
    if getattr(y, "placements", None) is None or not y.requires_grad:
        return y
    return _InnerGradGather.apply(y)


class _GradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.mesh, ctx.placements = y.device_mesh, tuple(y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def keep_grad_layout(y):
    """Identity whose backward lays the gradient out as ``y`` is (DTensor
    may otherwise hand back a layout that the ops before ``y`` must gather
    whole); any other value as it is."""
    if getattr(y, "placements", None) is None or not y.requires_grad:
        return y
    return _GradLayout.apply(y)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(x, grad_placements=None):
    """The DTensor ``x``'s local shard, its gradient handed back to the
    DTensor contiguous: DTensor lays a local gradient out as the global
    one (contiguous) and views it so, which fails on the transposed
    gradients of a local einsum."""
    local = x.to_local(grad_placements=grad_placements)
    if not (torch.is_grad_enabled() and local.requires_grad):
        return local
    return _ContiguousGrad.apply(local)


def plain(x):
    """A DTensor's full tensor; any other value as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, spec, mesh):
    """``x`` redistributed to ``spec`` on ``mesh`` (a DTensor), else ``x``."""
    if not _is_dtensor(x):
        return x
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shard(x, *logical: str | None):
    """Redistribute a DTensor to the logical axes' spec; a no-op without
    an ambient mesh or on a plain tensor."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return _constrain(x, axis_rules().resolve(*logical, mesh=mesh), mesh)


def shard_div(x, logical: tuple[str | None, ...]):
    """Like :func:`shard` but SKIPS the whole constraint if any requested
    axis does not divide its dimension: pinning a non-divisible dim would
    force it to replicate; left alone, the layout stays what propagation
    gave it."""
    mesh = active_mesh()
    if mesh is None:
        return x
    requested = axis_rules().resolve(*logical, mesh=mesh)
    achieved = param_spec(logical, tuple(x.shape), mesh=mesh)
    if tuple(requested) != tuple(achieved):
        return x
    return _constrain(x, achieved, mesh)


FSDP_AXIS = "data"
FSDP_MIN_ELEMS = 1 << 20


def fsdp_leaf_spec(spec, shape: tuple[int, ...], mesh=None,
                   axis: str = FSDP_AXIS, min_elems: int = FSDP_MIN_ELEMS,
                   layers: int = 1) -> P:
    """ZeRO-3: add ``axis`` to the largest replicated, divisible dim of a
    big leaf.  ``layers`` > 1 marks a per-layer leaf: it is sized, and its
    dim chosen, as the reference's stacked ``(layers, *shape)`` leaf (whose
    layer entry is replicated); where the reference would shard the layer
    axis itself, a per-layer leaf cannot and keeps ``spec``."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return P(*spec)
    sizes = mesh_axes(mesh)
    if axis not in sizes:
        return P(*spec)
    lead = 1 if layers > 1 else 0
    full = (layers,) * lead + tuple(shape)
    n = 1
    for s in full:
        n *= s
    if n < min_elems:
        return P(*spec)
    entries = [None] * lead + list(spec) + [None] * (len(shape) - len(spec))
    if axis not in {a for e in entries for a in _axes(e)}:
        ways = sizes[axis]
        best, best_dim = -1, -1
        for d, e in enumerate(entries):
            if e is None and full[d] % ways == 0 and full[d] > best:
                best, best_dim = full[d], d
        if best_dim >= lead:
            entries[best_dim] = axis
    return P(*entries[lead:])


def constrain_tree(params: Mapping, spec_tree: Mapping) -> dict:
    """Every tensor of ``params`` (name → tensor) redistributed to its spec
    in ``spec_tree``; no-op without a mesh.  The reference pins a block's
    FSDP layout here and lets GSPMD gather the weights at use; the port's
    blocks pass their tensor-parallel specs, which is the ZeRO-3 gather
    itself (DTensor would otherwise pick its own collectives)."""
    mesh = active_mesh()
    if mesh is None:
        return dict(params)
    return {name: _constrain(x, spec_tree[name], mesh)
            for name, x in params.items()}


def block_weights(module, specs: Mapping) -> dict:
    """``module``'s parameters by name (``named_parameters()``); under a
    mesh, DTensors redistributed to their specs in ``specs`` (the ZeRO-3
    gather at the top of a block)."""
    params = dict(module.named_parameters())
    if active_mesh() is None:
        return params
    return constrain_tree(params, specs)


def subtree(params: Mapping, prefix: str) -> dict:
    """The entries of ``params`` under ``prefix`` ("attn."), the prefix
    taken off their names."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def param_spec(shape_logical: tuple[str | None, ...],
               divisibility: tuple[int, ...] | None = None,
               mesh=None) -> P:
    """Spec for a parameter; if ``divisibility`` is given, axes whose size
    does not divide by the mesh-axis size are replicated instead (56 query
    heads on model = 16 still shard, 8 kv heads on model = 16 replicate:
    the Megatron kv-replication scheme)."""
    rules = axis_rules()
    mesh = mesh if mesh is not None else active_mesh()
    spec = list(rules.resolve(*shape_logical, mesh=mesh))
    if divisibility is not None and mesh is not None:
        sizes = mesh_axes(mesh)
        for k, (target, dim) in enumerate(zip(spec, divisibility)):
            if target is None or dim <= 0:
                continue
            total = 1
            for a in _axes(target):
                total *= sizes.get(a, 1)
            if dim % total != 0:
                spec[k] = None
    return P(*spec)
