"""Checkpoint/restart: atomic, step-tagged, keep-N — the counterpart of
``repro.runtime.checkpoint``.

Layout, as the reference's: ``<dir>/step_<N>/``: ``manifest.json`` (the
leaf count, the leaves' paths, extra metadata such as the pipeline cursor)
and ``arrays.npz`` (the leaves ``a0``, ``a1``, … copied to the host).
Writes go to ``step_<N>.tmp`` and are published by ``os.rename``, so a
crash mid-write never corrupts the latest checkpoint, and only the newest
``keep`` are kept.

A state is a nested dict of tensors — the trainer saves ``{"model":
model.state_dict(), "opt": opt_state}`` — flattened in its insertion order.
numpy has no bfloat16, so a bf16 leaf is stored as float32 (exactly) and
cast back on restore.  :func:`restore_checkpoint` rebuilds the target's
structure, raising on a leaf count or shape mismatch, with every leaf in
the target leaf's dtype and on its device (mesh shardings wait for the
mesh slice).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "available_steps"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) for every tensor of a nested dict, in its order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out += _flatten(v, path)
        else:
            out.append((path, v))
    return out


def _unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    return build(tree)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_checkpoint(ckpt_dir, step: int, state: dict,
                    extra: dict | None = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f"step_{step}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten(state)
    np.savez(tmp / "arrays.npz",
             **{f"a{i}": _host(t) for i, (_, t) in enumerate(flat)})
    manifest = {"step": step, "n_leaves": len(flat),
                "paths": [p for p, _ in flat], "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(available_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def available_steps(ckpt_dir) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = _STEP_RE.match(p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: int, target_state: dict
                       ) -> tuple[dict, dict]:
    """Restore into the structure of ``target_state``: each leaf in the
    target leaf's dtype, on its device.  Returns (state, extra metadata).
    Raises ValueError on a leaf count or a shape mismatch."""
    path = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "arrays.npz")
    flat = _flatten(target_state)
    if manifest["n_leaves"] != len(flat):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target has "
            f"{len(flat)} — incompatible states")
    out = []
    for i, (name, tgt) in enumerate(flat):
        arr = data[f"a{i}"]
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"leaf {i} ({name}): checkpoint shape "
                             f"{arr.shape} != target {tuple(tgt.shape)}")
        out.append(torch.from_numpy(np.array(arr)).to(device=tgt.device,
                                                       dtype=tgt.dtype))
    return _unflatten(target_state, out), manifest["extra"]
