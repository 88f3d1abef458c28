"""Carry the reference's objects across to the port.

The port imports nothing of ``repro``, so its graph and fleet objects are
rebuilt from plain numpy arrays and Python scalars — what
``repro.core.OpGraph`` / ``repro.core.RegionFleetFamily`` hold and what the
reference's ``pack_fleets`` returns.  With these a test (or a user moving
a deployment across) feeds one graph and one fleet to both packages.
:func:`decoder_lm_from_arrays` (dense or MoE), :func:`mamba2_lm_from_arrays`,
:func:`zamba2_lm_from_arrays`, :func:`vision_lm_from_arrays` and
:func:`enc_dec_lm_from_arrays` do the same for a model's parameter tree
(qwen3's q/k-norm weights, the MoE experts and the VLM's gates
included), so both packages run one model, and :func:`cache_from_arrays`
for a serving cache, so a decode can start from the other package's
prefill.  Each raises on a tree that is not its family's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.devices import RegionFleetFamily
from repro_torch.core.graph import Operator, OpGraph
from repro_torch.kernels import dispatch
from repro_torch.models.api import ModelConfig
from repro_torch.models.hybrid import HybridCache, Zamba2LM
from repro_torch.models.layers import KVCache
from repro_torch.models.mamba2 import Mamba2LM, SSMCache
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.vlm import VisionLM, VLMCache
from repro_torch.models.whisper import EncDecCache, EncDecLM

__all__ = ["graph_from_arrays", "region_family_from_arrays",
           "dense_pack_from_array", "decoder_lm_from_arrays",
           "mamba2_lm_from_arrays", "zamba2_lm_from_arrays",
           "vision_lm_from_arrays", "enc_dec_lm_from_arrays",
           "cache_from_arrays"]


def graph_from_arrays(names, selectivity, out_bytes, work, dq_eligible,
                      edges) -> OpGraph:
    """An :class:`OpGraph` from per-operator columns and an (E, 2) edge
    list (pairs of operator indices)."""
    cols = [list(names), np.asarray(selectivity, dtype=np.float64),
            np.asarray(out_bytes, dtype=np.float64),
            np.asarray(work, dtype=np.float64),
            np.asarray(dq_eligible, dtype=bool)]
    if len({len(c) for c in cols}) != 1:
        raise ValueError("operator columns disagree on length: "
                         f"{[len(c) for c in cols]}")
    ops = [Operator(name=str(n), selectivity=float(s), out_bytes=float(b),
                    work=float(w), dq_eligible=bool(q))
           for n, s, b, w, q in zip(*cols)]
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return OpGraph(ops, [tuple(e) for e in edges.tolist()])


def region_family_from_arrays(region, inter, degrade, self_cost,
                              speed=None) -> RegionFleetFamily:
    """A :class:`RegionFleetFamily` from its (V,) region ids, (S, R, R)
    inter costs, (S, V) degrade multipliers, self cost and optional speeds
    ((V,) or (S, V))."""
    return RegionFleetFamily(
        region=np.array(region, dtype=np.int64),
        inter=np.array(inter, dtype=np.float64),
        degrade=np.array(degrade, dtype=np.float64),
        self_cost=float(self_cost),
        speed=None if speed is None else np.array(speed, dtype=np.float64))


def dense_pack_from_array(coms) -> np.ndarray:
    """A dense (S, V, V) float32 scenario pack, validated square."""
    arr = np.array(coms, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
        raise ValueError(f"dense pack must be (S, V, V), got {arr.shape}")
    return arr


def _put(p: torch.Tensor | None, arr, what: str) -> None:
    """Copy one leaf into ``p`` (bfloat16 leaves too); raise on a
    mis-shaped leaf."""
    arr = np.asarray(arr)
    if p is None:               # non-parametric norm: a (0,) leaf
        if arr.size:
            raise ValueError(f"{what}: non-parametric norm given "
                             f"weights {arr.shape}")
        return
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(f"{what}: shape {arr.shape}, want "
                         f"{tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(_tensor(arr, p.device))


def _leaves(tree, prefix: str = ""):
    """(path, array) for every leaf of a nested dict tree, paths joined
    by "/"."""
    for name, sub in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(sub, dict):
            yield from _leaves(sub, path)
        else:
            yield path, np.asarray(sub)


def _load_stacked(modules, tree, what: str) -> None:
    """Copy a tree stacked over ``len(modules)`` (a leading axis on every
    leaf) into the modules, leaf ``a/b`` into ``module.a[b]``.  Raises on
    a missing or extra leaf (a module's parameters against the tree's
    paths; a non-parametric norm's (n, 0) leaf stands for its ``None``),
    on a leaf with another count on its leading axis, or a mis-shaped
    one."""
    leaves = dict(_leaves(tree))
    for path, arr in leaves.items():
        if arr.ndim == 0 or arr.shape[0] != len(modules):
            raise ValueError(f"{what}/{path}: {arr.shape[:1]} layers, want "
                             f"{len(modules)}")
    for i, module in enumerate(modules):
        want = {n.replace(".", "/") for n, _ in module.named_parameters()}
        got = set()
        for path, arr in leaves.items():
            target = module
            for part in path.split("/"):
                target = target[part] if isinstance(
                    target, nn.ParameterDict) and part in target \
                    else getattr(target, part, False)
                if target is False:
                    raise ValueError(f"{what}: no leaf {path!r} in "
                                     f"{type(module).__name__}")
            _put(target, arr[i], f"{what}/{path}")
            if target is not None:
                got.add(path)
        if got != want:
            raise ValueError(f"{what}: leaves {sorted(got)}, want "
                             f"{sorted(want)}")


def _check_keys(tree, want: set, kind: str) -> None:
    if set(tree) != want:
        raise ValueError(f"not a {kind} tree: {sorted(tree)}, want "
                         f"{sorted(want)}")


def _put_ends(model, tree) -> None:
    """``embed``, ``head``, ``final_norm`` (and ``enc_norm`` where the
    model has one)."""
    for name in ("embed", "head", "final_norm", "enc_norm"):
        if name in tree:
            _put(getattr(model, name), tree[name], name)


def _decoder_keys(cfg: ModelConfig) -> set:
    return {"ln1", "ln2", "attn", "moe" if cfg.moe_experts else "mlp"}


def decoder_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> DecoderLM:
    """A :class:`DecoderLM` on ``device`` holding the reference's parameter
    tree, given as nested dicts of numpy arrays: ``embed`` (V_pad, d),
    ``blocks`` with a leading layer axis (``attn`` flat (L, d, H·hd), norm
    weights or (L, 0) placeholders, and ``mlp`` or, with experts, ``moe``:
    ``router`` (L, d, E), ``wi_gate`` / ``wi_up`` (L, E, d, f), ``wo``
    (L, E, f, d) and Arctic's ``dense_residual``), ``final_norm`` and
    ``head`` (d, V_pad).  Raises on a missing, extra or mis-shaped leaf."""
    model = DecoderLM(cfg, device=device)
    kind = "MoE DecoderLM" if cfg.moe_experts else "dense DecoderLM"
    _check_keys(tree, {"embed", "blocks", "final_norm", "head"}, kind)
    _check_keys(tree["blocks"], _decoder_keys(cfg), f"{kind} blocks")
    _put_ends(model, tree)
    _load_stacked(model.blocks, tree["blocks"], "blocks")
    return model


def vision_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> VisionLM:
    """A :class:`VisionLM` on ``device`` holding the reference's parameter
    tree: the decoder's (:func:`decoder_lm_from_arrays`) and ``cross``
    stacked over the ⌈L / cross_attn_every⌉ cross blocks (``ln``, ``attn``
    wq/wk/wv/wo flat, the scalar ``gate``).  Raises on a missing, extra
    or mis-shaped leaf."""
    model = VisionLM(cfg, device=device)
    _check_keys(tree, {"embed", "blocks", "cross", "final_norm", "head"},
                "VisionLM")
    _check_keys(tree["blocks"], _decoder_keys(cfg), "VisionLM blocks")
    _put_ends(model, tree)
    _load_stacked(model.blocks, tree["blocks"], "blocks")
    _load_stacked(model.cross, tree["cross"], "cross")
    return model


def enc_dec_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> EncDecLM:
    """An :class:`EncDecLM` on ``device`` holding the reference's parameter
    tree: ``embed``, ``encoder`` stacked over the encoder layers (``ln1``,
    ``attn``, ``ln2``, ``mlp`` wi/wo), ``decoder`` stacked over the layers
    (``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``),
    ``enc_norm``, ``final_norm`` and ``head``.  Raises on a missing, extra
    or mis-shaped leaf."""
    model = EncDecLM(cfg, device=device)
    _check_keys(tree, {"embed", "encoder", "decoder", "enc_norm",
                       "final_norm", "head"}, "EncDecLM")
    _put_ends(model, tree)
    _load_stacked(model.encoder, tree["encoder"], "encoder")
    _load_stacked(model.decoder, tree["decoder"], "decoder")
    return model


MAMBA2_LEAVES = ("norm", "wz", "wx", "wB", "wC", "wdt", "conv_w", "conv_b",
                 "A_log", "D", "dt_bias", "gate_norm", "out_proj")


def _stack1(tree):
    """``tree`` with a leading axis of 1 on every leaf: one module's
    parameters as a stack of one."""
    return {k: _stack1(v) if isinstance(v, dict) else np.asarray(v)[None]
            for k, v in tree.items()}


def mamba2_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> Mamba2LM:
    """A :class:`Mamba2LM` on ``device`` holding the reference's parameter
    tree, given as nested dicts of numpy arrays: ``embed`` (V_pad, d),
    ``blocks`` with a leading layer axis (``norm``, ``wz``, ``wx``, ``wB``,
    ``wC``, ``wdt``, ``conv_w`` (L, k, d_inner + 2N), ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``, ``gate_norm``, ``out_proj``),
    ``final_norm`` and ``head`` (d, V_pad).  Raises on a missing, extra or
    mis-shaped leaf."""
    model = Mamba2LM(cfg, device=device)
    _check_keys(tree, {"embed", "blocks", "final_norm", "head"}, "Mamba2LM")
    _check_keys(tree["blocks"], set(MAMBA2_LEAVES), "Mamba2LM")
    _put_ends(model, tree)
    _load_stacked(model.blocks, tree["blocks"], "blocks")
    return model


def zamba2_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> Zamba2LM:
    """A :class:`Zamba2LM` on ``device`` holding the reference's parameter
    tree, given as nested dicts of numpy arrays: ``embed``, ``blocks`` (the
    Mamba2 leaves of :func:`mamba2_lm_from_arrays`, stacked over the L
    layers), ``shared_attn`` (``ln1``, ``attn`` wq/wk/wv/wo flat, ``ln2``,
    ``mlp``: one parameter set, no layer axis), ``final_norm`` and
    ``head``.  Raises on a missing, extra or mis-shaped leaf."""
    model = Zamba2LM(cfg, device=device)
    _check_keys(tree, {"embed", "blocks", "shared_attn", "final_norm",
                       "head"}, "Zamba2LM")
    _check_keys(tree["blocks"], set(MAMBA2_LEAVES), "Zamba2LM")
    _check_keys(tree["shared_attn"], {"ln1", "attn", "ln2", "mlp"},
                "Zamba2LM")
    _put_ends(model, tree)
    _load_stacked([model.shared_attn], _stack1(tree["shared_attn"]),
                  "shared_attn")
    _load_stacked(model.blocks, tree["blocks"], "blocks")
    return model


def _tensor(arr, device) -> torch.Tensor:
    """A writable tensor copy of ``arr``; bfloat16 arrays (which numpy
    knows only through ml_dtypes) go through float32, exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def cache_from_arrays(cache, device=None) -> (
        KVCache | SSMCache | HybridCache | VLMCache | EncDecCache):
    """The port's serving cache from the reference's: a ``KVCache``
    (``k``, ``v`` (L, B, S_max, K·hd)), an ``SSMCache`` (``state``
    (L, B, H, N, P), ``conv`` (L, B, k−1, Dc)), a ``HybridCache`` (an
    ``SSMCache`` ``ssm`` over the layers and a ``KVCache`` ``attn`` over
    the attention sites), or a ``VLMCache`` / ``EncDecCache`` (a
    ``KVCache`` ``self_attn`` over the layers and one ``cross`` over the
    cross blocks / decoder layers; told apart by the class's name, as the
    two hold the same fields), its leaves given as arrays numpy can read,
    copied to ``device`` (``None`` → the card) in their dtype."""
    dev = dispatch.resolve_device(device)
    if hasattr(cache, "ssm") and hasattr(cache, "attn"):
        return HybridCache(cache_from_arrays(cache.ssm, dev),
                           cache_from_arrays(cache.attn, dev))
    pair = {"VLMCache": VLMCache, "EncDecCache": EncDecCache}.get(
        type(cache).__name__)
    if pair is not None:
        return pair(cache_from_arrays(cache.self_attn, dev),
                    cache_from_arrays(cache.cross, dev))
    if hasattr(cache, "k") and hasattr(cache, "v"):
        return KVCache(_tensor(cache.k, dev), _tensor(cache.v, dev))
    if hasattr(cache, "state") and hasattr(cache, "conv"):
        return SSMCache(_tensor(cache.state, dev), _tensor(cache.conv, dev))
    raise TypeError(f"not a KVCache or SSMCache (or a HybridCache, "
                    f"VLMCache or EncDecCache of them): "
                    f"{type(cache).__name__}")
