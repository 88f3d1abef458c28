"""Sharding plans: the FSDP transform of the parameters and the inputs of
each (arch × shape) cell — the counterpart of ``repro.launch.shardings``.

``fsdp_specs`` is ZeRO-3: every large parameter gets its largest
still-replicated dimension split over the intra-pod ``data`` axis on top
of its tensor-parallel spec; the model gathers the weights at each block
(``repro_torch.models.transformer``) and the gradients are reduced back to
this layout.  The ``pod`` axis is deliberately NOT used for FSDP: the
parameter gathers would cross the slow network tier every step.

The port's trees are flat, keyed like ``named_parameters()``, with one
tensor per layer.  A leaf's size is counted as the reference's stacked
leaf's: its layer count is the number of names that differ from its own
only in their integer components (``blocks.3.attn.wq`` counts every
``blocks.*.attn.wq``), and ``FSDP_MIN_SIZE`` applies to that many times
its elements.

``input_specs`` gives the cell's step inputs as DTensors whose local
tensors are meta (or, inside ``repro_torch.perf.counts.without_data``,
fake) tensors: shapes, dtypes and placements with no memory.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from repro_torch.configs.registry import Shape
from repro_torch.models.api import ModelConfig
from repro_torch.models.sharding import (P, distribute, fsdp_leaf_spec,
                                         mesh_axes)

__all__ = ["FSDP_MIN_SIZE", "fsdp_specs", "choose_batch_axes", "batch_specs",
           "cache_len", "input_specs", "layer_counts", "shard_params",
           "shard_model", "shard_cache"]

FSDP_MIN_SIZE = 1 << 20  # leaves smaller than 1M elements stay as they are


def _pattern(name: str) -> str:
    return ".".join("*" if part.isdigit() else part
                    for part in name.split("."))


def layer_counts(names) -> dict[str, int]:
    """name → the number of names sharing its pattern with the integer
    components wildcarded (1 for a leaf outside any layer list)."""
    names = list(names)
    count = Counter(map(_pattern, names))
    return {n: count[_pattern(n)] if _pattern(n) != n else 1 for n in names}


def fsdp_specs(spec_tree, shape_tree, mesh, axis: str = "data",
               min_elems: int = FSDP_MIN_SIZE, layers: int = 1):
    """Add ``axis`` to the largest divisible replicated dim of big leaves
    (the shared leaf rule, ``repro_torch.models.sharding.
    fsdp_leaf_spec``).  ``spec_tree`` and ``shape_tree`` are nested
    mappings alike; a leaf of ``shape_tree`` is a tensor or a shape."""
    if isinstance(spec_tree, P) or spec_tree is None:
        shape = tuple(getattr(shape_tree, "shape", shape_tree))
        return fsdp_leaf_spec(spec_tree or P(), shape, mesh, axis,
                              min_elems, layers)
    counts = layer_counts(spec_tree)
    return {k: fsdp_specs(v, shape_tree[k], mesh, axis, min_elems,
                          layers * counts[k])
            for k, v in spec_tree.items()}


def choose_batch_axes(global_batch: int, mesh) -> tuple[str, ...]:
    """Largest ("pod", "data") prefix whose product divides the batch —
    long_500k has batch 1, which cannot be split over the data axes."""
    sizes = mesh_axes(mesh)
    for axes in (("pod", "data"), ("data",), ("pod",), ()):
        if all(a in sizes for a in axes):
            ways = 1
            for a in axes:
                ways *= sizes[a]
            if ways and global_batch % ways == 0:
                return axes
    return ()


def batch_specs(mesh, global_batch: int | None = None) -> P:
    if global_batch is None:
        sizes = mesh_axes(mesh)
        axes = tuple(a for a in ("pod", "data") if a in sizes)
    else:
        axes = choose_batch_axes(global_batch, mesh)
    if not axes:
        return P()
    return P(axes if len(axes) > 1 else axes[0])


def cache_len(shape: Shape) -> int:
    """KV / cache capacity for a cell: prefill writes seq_len; decode
    holds a cache of seq_len and appends one token (capacity + 128)."""
    if shape.kind == "decode":
        return shape.seq_len + 128
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: Shape, mesh,
                device="meta") -> dict:
    """The cell's step inputs (the batch part only) as DTensors on
    ``mesh`` over ``device`` tensors (meta: no memory), laid out by
    :func:`batch_specs`."""
    B = shape.global_batch
    bspec = batch_specs(mesh, B)

    def sds(shp, dtype, spec):
        return distribute(torch.empty(shp, dtype=dtype, device=device),
                          spec, mesh)

    row = P(*bspec, None)
    out = {}
    if shape.kind == "train":
        out["tokens"] = sds((B, shape.seq_len), torch.int32, row)
        out["labels"] = sds((B, shape.seq_len), torch.int32, row)
    elif shape.kind == "prefill":
        out["tokens"] = sds((B, shape.seq_len), torch.int32, row)
    else:  # decode
        out["tokens"] = sds((B, 1), torch.int32, row)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["image_embeds"] = sds((B, cfg.n_image_tokens, cfg.d_model),
                                  torch.float32, P(*bspec, None, None))
    if cfg.family == "audio" and shape.kind != "decode":
        out["audio_frames"] = sds((B, cfg.n_audio_frames, cfg.d_model),
                                  torch.float32, P(*bspec, None, None))
    return out


def shard_params(model, specs: dict, mesh) -> None:
    """Replace each parameter of ``model`` by a DTensor laid out by its
    spec in ``specs`` (name → spec), each device keeping its chunk of the
    full tensor it holds (no communication); ``requires_grad`` is kept."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        dt = distribute(p.data, specs[name], mesh)
        setattr(mod, leaf, torch.nn.Parameter(dt,
                                              requires_grad=p.requires_grad))


def shard_model(model, mesh) -> dict:
    """``model``'s parameters laid out by its ``param_specs()`` with the
    FSDP axis added (``fsdp_specs``); returns the specs."""
    specs = fsdp_specs(model.param_specs(), dict(model.named_parameters()),
                       mesh)
    shard_params(model, specs, mesh)
    return specs


def shard_cache(cache, spec_tree, mesh):
    """A cache dataclass (``KVCache``, ``SSMCache``, or one nesting them:
    ``HybridCache``, ``VLMCache``, ``EncDecCache``) with each tensor laid
    out by its spec in ``spec_tree`` (a cache of specs alike)."""
    def lay(leaf, spec):
        if dataclasses.is_dataclass(leaf):
            return shard_cache(leaf, spec, mesh)
        return distribute(leaf, spec, mesh)

    return type(cache)(**{
        f.name: lay(getattr(cache, f.name), getattr(spec_tree, f.name))
        for f in dataclasses.fields(cache)})
