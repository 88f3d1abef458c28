"""Gradient compression for the slow tier — the single-device part of
``repro.train.compress``.

int8 block quantization with error feedback: each step transmits
quantize(g + e) and keeps e ← (g + e) − dequant(quantize(g + e)) locally,
which makes the scheme unbiased over time.  ``compress_decompress`` is
what a receiver reconstructs; ``ef_compress_step`` and
:class:`ErrorFeedbackState` carry the error.  ``compressed_psum`` (the
int8 all-gather over a mesh axis) needs a process group and waits for the
mesh slice.
"""

from __future__ import annotations

import torch

from repro_torch.train.optim import dequantize_blockwise, quantize_blockwise

__all__ = ["compress_decompress", "ErrorFeedbackState", "ef_compress_step"]


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
