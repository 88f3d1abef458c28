"""The yardstick's frozen counts: the card's peaks and the least time of K6
and of its backward.  Each family's model FLOPs are in its file under
:mod:`portbench.families`.

They follow only the shapes the traffic hands the program and the sizes of
the configuration file, never who implements them, so a later change to
the program cannot make them stale.

* The peaks are copied from ``src/repro_torch/perf/roofline.py:33-40``
  (NVIDIA's data sheet, H100 SXM at 700 W, dense rates).
* :func:`ssd_scan_terms` and :func:`ssd_scan_bwd_terms` are copies of
  ``src/repro_torch/perf/roofline.py:206-254``: each input read once and
  each output written once, the operations of the chunked scan at its
  published chunk.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3, 700 W (data sheet, SXM): dense bf16 tensor cores
PEAK_BF16_TC = 989e12
# FP32 without tensor cores
PEAK_FP32 = 67e12
# HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12

_WIDTH = {"float32": (4, PEAK_FP32), "bfloat16": (2, PEAK_BF16_TC)}


@dataclasses.dataclass(frozen=True)
class Terms:
    flops: float
    bytes: float
    peak: float

    @property
    def seconds(self) -> float:
        """The least time: the larger of operations over the peak and bytes
        over the bandwidth."""
        return max(self.flops / self.peak, self.bytes / HBM_BW)


def ssd_scan_terms(b: int, L: int, H: int, P: int, N: int, chunk: int,
                   dtype: str) -> Terms:
    """K6: x (b, L, H, P), B and C (b, L, N) of ``dtype``, float32 dt;
    per (row, chunk) of Q rows ``2Q²N + Q(Q+1)·H·P + 4QNHP`` operations;
    x, B, C, dt read once, y written once."""
    width, peak = _WIDTH[dtype]
    Q = max(min(chunk, L), 1)
    n = -(-L // Q)
    per_chunk = 2.0 * Q * Q * N + Q * (Q + 1.0) * H * P + 4.0 * Q * N * H * P
    bytes_ = b * L * (2.0 * H * P * width + 2.0 * N * width + 4.0 * H) \
        + 8.0 * H
    return Terms(b * n * per_chunk, bytes_, peak)


def ssd_scan_bwd_terms(b: int, L: int, H: int, P: int, N: int, chunk: int,
                       dtype: str) -> Terms:
    """K6's backward on the operands of :func:`ssd_scan_terms` and dy:
    per (row, chunk) ``2Q²N + 2Q(Q+1)·H·P + 2Q(Q+1)·N + 10QNHP``
    operations; x, dy, B, C, dt read once, dx, dB, dC, ddt written once."""
    width, peak = _WIDTH[dtype]
    Q = max(min(chunk, L), 1)
    n = -(-L // Q)
    per_chunk = (2.0 * Q * Q * N + 2.0 * Q * (Q + 1.0) * H * P
                 + 2.0 * Q * (Q + 1.0) * N + 10.0 * Q * N * H * P)
    bytes_ = b * L * (3.0 * H * P * width + 4.0 * N * width + 8.0 * H) \
        + 16.0 * H
    return Terms(b * n * per_chunk, bytes_, peak)


def ssm_shape(model: dict) -> dict:
    """The SSD scan's head count, head size, state and chunk for a
    configuration's ``model`` sizes."""
    d_inner = model["ssm_expand"] * model["d_model"]
    return {"H": d_inner // model["ssm_head_dim"], "P": model["ssm_head_dim"],
            "N": model["ssm_state"], "chunk": model["ssm_chunk"],
            "d_inner": d_inner}
