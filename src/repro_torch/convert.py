"""Carry the reference's objects across to the port.

The port imports nothing of ``repro``, so its graph and fleet objects are
rebuilt from plain numpy arrays and Python scalars — what
``repro.core.OpGraph`` / ``repro.core.RegionFleetFamily`` hold and what the
reference's ``pack_fleets`` returns.  With these a test (or a user moving
a deployment across) feeds one graph and one fleet to both packages.
:func:`decoder_lm_from_arrays` and :func:`mamba2_lm_from_arrays` do the
same for a ``DecoderLM``'s and a ``Mamba2LM``'s parameter tree, so both
packages run one model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.devices import RegionFleetFamily
from repro_torch.core.graph import Operator, OpGraph
from repro_torch.models.api import ModelConfig
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import DecoderLM

__all__ = ["graph_from_arrays", "region_family_from_arrays",
           "dense_pack_from_array", "decoder_lm_from_arrays",
           "mamba2_lm_from_arrays"]


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
    """Copy one leaf into ``p``; raise on a mis-shaped leaf."""
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
        p.copy_(torch.from_numpy(np.array(arr)))  # a writable copy


def decoder_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> DecoderLM:
    """A :class:`DecoderLM` on ``device`` holding the reference's parameter
    tree, given as nested dicts of numpy arrays: ``embed`` (V_pad, d),
    ``blocks`` with a leading layer axis (``attn`` flat (L, d, H·hd), ``mlp``,
    norm weights or (L, 0) placeholders), ``final_norm`` and ``head``
    (d, V_pad).  Raises on a missing, extra or mis-shaped leaf."""
    model = DecoderLM(cfg, device=device)
    blocks = tree["blocks"]
    if set(tree) != {"embed", "blocks", "final_norm", "head"} \
            or set(blocks) != {"ln1", "ln2", "attn", "mlp"}:
        raise ValueError(f"not a dense DecoderLM tree: {sorted(tree)} / "
                         f"{sorted(blocks)}")
    _put(model.embed, tree["embed"], "embed")
    _put(model.head, tree["head"], "head")
    _put(model.final_norm, tree["final_norm"], "final_norm")
    stacked = {"ln1": np.asarray(blocks["ln1"]),
               "ln2": np.asarray(blocks["ln2"])}
    for group in ("attn", "mlp"):
        want = set(getattr(model.blocks[0], group))
        if set(blocks[group]) != want:
            raise ValueError(f"blocks/{group}: leaves "
                             f"{sorted(blocks[group])}, want {sorted(want)}")
        stacked.update({f"{group}/{n}": np.asarray(a)
                        for n, a in blocks[group].items()})
    for what, arr in stacked.items():
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{what}: {arr.shape[0]} layers, want "
                             f"{cfg.n_layers}")
    for li, blk in enumerate(model.blocks):
        _put(blk.ln1, stacked["ln1"][li], "blocks/ln1")
        _put(blk.ln2, stacked["ln2"][li], "blocks/ln2")
        for group in ("attn", "mlp"):
            for name, p in getattr(blk, group).items():
                _put(p, stacked[f"{group}/{name}"][li],
                     f"blocks/{group}/{name}")
    return model


MAMBA2_LEAVES = ("norm", "wz", "wx", "wB", "wC", "wdt", "conv_w", "conv_b",
                 "A_log", "D", "dt_bias", "gate_norm", "out_proj")


def mamba2_lm_from_arrays(cfg: ModelConfig, tree, device=None) -> Mamba2LM:
    """A :class:`Mamba2LM` on ``device`` holding the reference's parameter
    tree, given as nested dicts of numpy arrays: ``embed`` (V_pad, d),
    ``blocks`` with a leading layer axis (``norm``, ``wz``, ``wx``, ``wB``,
    ``wC``, ``wdt``, ``conv_w`` (L, k, d_inner + 2N), ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``, ``gate_norm``, ``out_proj``),
    ``final_norm`` and ``head`` (d, V_pad).  Raises on a missing, extra or
    mis-shaped leaf."""
    model = Mamba2LM(cfg, device=device)
    blocks = tree["blocks"] if "blocks" in tree else {}
    if set(tree) != {"embed", "blocks", "final_norm", "head"} \
            or set(blocks) != set(MAMBA2_LEAVES):
        raise ValueError(f"not a Mamba2LM tree: {sorted(tree)} / "
                         f"{sorted(blocks)}")
    _put(model.embed, tree["embed"], "embed")
    _put(model.head, tree["head"], "head")
    _put(model.final_norm, tree["final_norm"], "final_norm")
    stacked = {n: np.asarray(a) for n, a in blocks.items()}
    for what, arr in stacked.items():
        if arr.ndim == 0 or arr.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{what}: {arr.shape[:1]} layers, want "
                             f"{cfg.n_layers}")
    for li, blk in enumerate(model.blocks):
        for name in MAMBA2_LEAVES:
            _put(getattr(blk, name), stacked[name][li], f"blocks/{name}")
    return model
