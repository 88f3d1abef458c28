"""Roofline terms on one NVIDIA H100 — the port's own ``compute_terms``,
which the serving layer's admission pricer runs its FLOP/byte counts
through (``repro_torch.serve.admission``), the single-tile edge-latency
kernels' bounds (:func:`edge_latency_single_tile_terms`,
:func:`edge_latency_structured_single_tile_terms`) and the LM kernels'
(:func:`flash_attention_terms`, :func:`ssd_scan_terms`,
:func:`rmsnorm_terms`).

  compute_s = FLOPs / peak (FP32 by default)
  memory_s  = bytes / HBM_BW

The edge-latency kernels compute in full FP32 on the CUDA cores (TF32
tensor cores miss the 1e-5 accuracy bar), so their compute peak is the
FP32 non-tensor rate.  Attention on bf16 operands is priced at the bf16
tensor-core rate, the least time the card could take for it, and so is
the SSD scan on bf16 operands.  RMSNorm is priced at the FP32 rate: its
few operations per element never reach a tensor core.  The rates
are NVIDIA's data-sheet numbers for the SXM part at its full power limit;
a card capped lower runs slower under load, which the pricer's
observed/bound calibration absorbs.  The reference's collective (ICI)
term has no user on one card.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): FP32 without tensor cores
PEAK_FLOPS = 67e12
# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): dense bf16 tensor cores
PEAK_BF16_TC = 989e12
# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12

__all__ = ["RooflineTerms", "compute_terms",
           "edge_latency_single_tile_terms",
           "edge_latency_structured_single_tile_terms",
           "flash_attention_terms",
           "ssd_scan_terms", "rmsnorm_terms", "PEAK_FLOPS", "PEAK_BF16_TC",
           "HBM_BW"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    flops: float = 0.0
    bytes: float = 0.0

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_by(self) -> str:
        """"operations" or "bytes": which term limits the bound."""
        return "operations" if self.dominant == "compute" else "bytes"

    @property
    def step_time_s(self) -> float:
        """Lower-bound time: the larger term (perfect overlap)."""
        return max(self.compute_s, self.memory_s)


def compute_terms(flops: float, bytes_: float,
                  peak: float = PEAK_FLOPS) -> RooflineTerms:
    """Roofline terms for ``flops`` operations at ``peak`` FLOP/s and
    ``bytes_`` of device memory traffic on one card."""
    return RooflineTerms(compute_s=flops / peak, memory_s=bytes_ / HBM_BW,
                         flops=flops, bytes=bytes_)


def edge_latency_single_tile_terms(B: int, E: int, V: int,
                                   com_batch: int) -> RooflineTerms:
    """The least time for K4a (K1's function) on float32 operands:
    ``2·B·E·V²`` operations (a multiply-add per (e, u, v)) at the FP32
    rate; bytes: x_i and x_j (B, E, V) and the (com_batch, V, V) com read
    once, the (B, E) output written once."""
    flops = 2.0 * B * E * V * V
    bytes_ = 4.0 * (2 * B * E * V + com_batch * V * V + B * E)
    return compute_terms(flops, bytes_)


def edge_latency_structured_single_tile_terms(B: int, E: int, V: int, R: int,
                                              scen_batch: int
                                              ) -> RooflineTerms:
    """The least time for K4b (K2's function) on float32 operands:
    ``2·B·E·R·V`` operations (mass @ a) at the FP32 rate; bytes: x_i, x_j
    (B, E, V), mass (B, E, R), a (Bc, R, V) and corr (Bc, 1, V) read once,
    the (B, E) output written once."""
    flops = 2.0 * B * E * R * V
    bytes_ = 4.0 * (2 * B * E * V + B * E * R + scen_batch * (R + 1) * V
                    + B * E)
    return compute_terms(flops, bytes_)


_ATTN_OPERANDS = {"float32": (4, PEAK_FLOPS), "bfloat16": (2, PEAK_BF16_TC)}


def _operands(dtype, what: str) -> tuple[int, float]:
    """(bytes per element, peak FLOP/s) for operands of ``dtype``."""
    name = str(dtype).removeprefix("torch.")
    if name not in _ATTN_OPERANDS:
        raise ValueError(f"no {what} peak for dtype {dtype}; "
                         f"known: {sorted(_ATTN_OPERANDS)}")
    return _ATTN_OPERANDS[name]


def flash_attention_terms(B: int, S: int, H: int, D: int, dtype,
                          causal: bool) -> RooflineTerms:
    """The least time for (B, S, H, D) self-attention with operands of
    ``dtype`` (a torch dtype or its name; float32 or bfloat16).

    Operations: q·kᵀ and p·v, 2 FLOPs per multiply-add each, over the
    (query, key) pairs the mask keeps — S(S+1)/2 per head when causal,
    S² when not: ``4·B·H·D·S(S+1)/2`` or ``4·B·H·D·S²``.  Bytes: q, k, v
    read once and the output written once, at the operands' width.  The
    peak is the bf16 tensor-core rate for bf16 operands and the FP32 rate
    for float32 ones.  ``.bound_by`` says which limit the bound."""
    width, peak = _operands(dtype, "attention")
    pairs = S * (S + 1) / 2 if causal else float(S) * S
    flops = 4.0 * B * H * D * pairs
    bytes_ = 4.0 * B * S * H * D * width
    return compute_terms(flops, bytes_, peak=peak)


def ssd_scan_terms(b: int, L: int, H: int, P: int, N: int, chunk: int,
                   dtype) -> RooflineTerms:
    """The least time for the Mamba2 SSD chunked scan of x (b, L, H, P),
    B/C (b, L, N) of ``dtype`` (float32 or bfloat16) with float32 dt.

    Operations, per (row, chunk) of Q = min(chunk, L) rows:
    ``2Q²N`` (C·Bᵀ, shared by the heads) + ``Q(Q+1)·H·P`` (the
    lower-triangular M·x) + ``2QNHP`` (the carried-state term) +
    ``2QNHP`` (the state update), over ⌈L/Q⌉ chunks.  Bytes: x, B, C and
    dt (and A, D) read once, y written once.  The peak is the bf16
    tensor-core rate for bf16 operands and the FP32 rate for float32 ones.
    ``.bound_by`` says which limit binds."""
    width, peak = _operands(dtype, "SSD-scan")
    Q = max(min(chunk, L), 1)
    n = -(-L // Q)
    per_chunk = (2.0 * Q * Q * N + Q * (Q + 1.0) * H * P
                 + 4.0 * Q * N * H * P)
    flops = b * n * per_chunk
    bytes_ = b * L * (2.0 * H * P * width + 2.0 * N * width + 4.0 * H) \
        + 8.0 * H
    return compute_terms(flops, bytes_, peak=peak)


def rmsnorm_terms(rows: int, D: int, dtype) -> RooflineTerms:
    """The least time for RMSNorm of x (rows, D) of ``dtype`` (float32 or
    bfloat16) with a float32 weight: x read once, y written once, w read
    once; 4 operations per element (square, add, two products) at the FP32
    rate.  ``.bound_by`` says which limit binds (bytes, by far)."""
    width, _ = _operands(dtype, "RMSNorm")
    flops = 4.0 * rows * D
    bytes_ = 2.0 * rows * D * width + 4.0 * D
    return compute_terms(flops, bytes_, peak=PEAK_FLOPS)
