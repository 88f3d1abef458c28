"""Gradient compression for the slow tier — the counterpart of
``repro.train.compress``.

int8 block quantization with error feedback: each step transmits
quantize(g + e) and keeps e ← (g + e) − dequant(quantize(g + e)) locally,
which makes the scheme unbiased over time.  ``compress_decompress`` is
what a receiver reconstructs; ``ef_compress_step`` and
:class:`ErrorFeedbackState` carry the error.  ``compressed_psum`` is the
int8 collective over one mesh axis: quantize locally, all-gather the int8
payload and the scales over the axis's process group, dequantize and
average in rank order — 4× fewer bytes on the wire than float32.
"""

from __future__ import annotations

import torch

from repro_torch.train.optim import dequantize_blockwise, quantize_blockwise

__all__ = ["compress_decompress", "compressed_psum", "ErrorFeedbackState",
           "ef_compress_step"]


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """What the receiver reconstructs from one compressed gradient."""
    return dequantize_blockwise(quantize_blockwise(g), g.shape)


def ef_compress_step(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression: (the dequantized payload, the new
    error).  The caller averages payloads across workers."""
    corrected = g + err
    sent = compress_decompress(corrected)
    return sent, corrected - sent


class ErrorFeedbackState:
    """Per-leaf error accumulators: a dict keyed like the gradients."""

    @staticmethod
    def init(grads: dict) -> dict:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    @staticmethod
    def step(grads: dict, err_state: dict) -> tuple[dict, dict]:
        outs = {k: ef_compress_step(g.float(), err_state[k])
                for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})


def compressed_psum(g: torch.Tensor, axis_name: str,
                    mesh=None) -> torch.Tensor:
    """int8-on-the-wire mean of each device's ``g`` (a plain tensor, this
    device's value) over mesh axis ``axis_name`` of ``mesh`` (default: the
    ambient mesh): the payload and the scales are all-gathered over the
    axis's process group (``torch.distributed`` functional collectives),
    then dequantized and summed in rank order ``w = 0 .. n-1`` and divided
    by n, as the reference unrolls it."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.models.sharding import active_mesh
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh (use_mesh or mesh=)")
    group = mesh.get_group(axis_name)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis_name))
    qd = quantize_blockwise(g)
    q, scale = qd["q"], qd["scale"]
    qs = funcol.all_gather_tensor(q.reshape(1, *q.shape), 0, group)
    ss = funcol.all_gather_tensor(scale.reshape(1, *scale.shape), 0, group)
    total = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for w in range(n):      # unrolled: the axis is small (pods)
        total = total + dequantize_blockwise({"q": qs[w], "scale": ss[w]},
                                             g.shape)
    return total / n
