"""Roofline terms on one NVIDIA H100 — the port's own ``compute_terms``,
which the serving layer's admission pricer runs its FLOP/byte counts
through (``repro_torch.serve.admission``), the single-tile edge-latency
kernels' bounds (:func:`edge_latency_single_tile_terms`,
:func:`edge_latency_structured_single_tile_terms`) and the LM kernels'
(:func:`flash_attention_terms`, :func:`ssd_scan_terms`,
:func:`ssd_scan_bwd_terms`, :func:`rmsnorm_terms`, :func:`rmsnorm_bwd_terms`).

  compute_s = FLOPs / peak (FP32 by default)
  memory_s  = bytes / HBM_BW

The dense edge-latency kernels (K1, K4a) run on the tensor cores in split
TF32 — three TF32 products per multiply-add, since one TF32 product misses
the 1e-5 accuracy bar — so their least time is three times their
operations at the TF32 tensor-core rate (:func:`edge_latency_dense_terms`;
``route="fp32"`` prices the same work on the CUDA cores, the route they
replaced).  The structured ones compute in FP32 on the CUDA cores.  The
admission pricer keeps its FP32 prior for every kernel: its calibration
absorbs the gap.  Attention on bf16 operands is priced at the bf16
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
# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): dense TF32 tensor cores
PEAK_TF32_TC = 495e12
# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): NVLink 4, 900 GB/s per
# GPU in both directions together, so 450 GB/s each way; the ring model's
# wire bytes are what one card sends
NVLINK_BW = 450e9

__all__ = ["RooflineTerms", "compute_terms", "edge_latency_dense_terms",
           "edge_latency_single_tile_terms",
           "edge_latency_structured_single_tile_terms",
           "flash_attention_terms",
           "ssd_scan_terms", "ssd_scan_bwd_terms", "rmsnorm_terms",
           "rmsnorm_bwd_terms",
           "PEAK_FLOPS", "PEAK_BF16_TC",
           "PEAK_TF32_TC", "HBM_BW", "NVLINK_BW", "step_terms"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    flops: float = 0.0          # summed over chips
    bytes: float = 0.0          # summed over chips
    # a whole step's terms (step_terms); a kernel's bound leaves them 0
    collective_s: float = 0.0
    model_flops: float = 0.0
    wire_bytes_per_chip: float = 0.0
    chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_by(self) -> str:
        """"operations" or "bytes": which term limits the bound."""
        return "operations" if self.dominant == "compute" else "bytes"

    @property
    def step_time_s(self) -> float:
        """Lower-bound time: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """Model FLOPs over counted FLOPs: above 1 where the count skips
        work the analytic model charges (K5's causal half), below 1 where
        the step does work the model does not charge."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / self.flops

    @property
    def mfu_bound(self) -> float:
        """The model-FLOPs share of ``chips`` × the dense bf16 tensor-core
        peak at the bound: model FLOPs over chips × peak × step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_BF16_TC * t)

    def row(self) -> dict:
        """The reference's row, key for key (``hlo_flops`` holds the
        counted FLOPs summed over chips)."""
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops": self.flops,
            "useful_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "step_time_s": self.step_time_s,
            "chips": self.chips,
        }


def step_terms(flops: float, bytes_: float, wire_bytes: float, chips: int,
               model_flops: float) -> RooflineTerms:
    """A whole step's terms on ``chips`` cards, from one card's ``flops``
    (priced at the dense bf16 tensor-core peak), ``bytes_`` (at HBM_BW) and
    ``wire_bytes`` (at NVLINK_BW): the reference's post-SPMD convention."""
    return RooflineTerms(
        compute_s=flops * chips / (chips * PEAK_BF16_TC),
        memory_s=bytes_ * chips / (chips * HBM_BW),
        flops=flops * chips, bytes=bytes_ * chips,
        collective_s=wire_bytes / NVLINK_BW, model_flops=model_flops,
        wire_bytes_per_chip=wire_bytes, chips=chips)


def compute_terms(flops: float, bytes_: float,
                  peak: float = PEAK_FLOPS) -> RooflineTerms:
    """Roofline terms for ``flops`` operations at ``peak`` FLOP/s and
    ``bytes_`` of device memory traffic on one card."""
    return RooflineTerms(compute_s=flops / peak, memory_s=bytes_ / HBM_BW,
                         flops=flops, bytes=bytes_)


def edge_latency_dense_terms(B: int, E: int, V: int, com_batch: int,
                             route: str = "split_tf32") -> RooflineTerms:
    """The least time for K1's function on float32 operands: ``2·B·E·V²``
    operations (a multiply-add per (e, u, v)), priced for ``route``
    "split_tf32" (three TF32 products each, at the TF32 tensor-core rate)
    or "fp32" (at the FP32 CUDA-core rate); bytes: x_i and x_j (B, E, V)
    and the (com_batch, V, V) com read once, the (B, E) output written
    once."""
    peaks = {"split_tf32": PEAK_TF32_TC / 3, "fp32": PEAK_FLOPS}
    if route not in peaks:
        raise ValueError(f"unknown route {route!r}; known: {sorted(peaks)}")
    flops = 2.0 * B * E * V * V
    bytes_ = 4.0 * (2 * B * E * V + com_batch * V * V + B * E)
    return compute_terms(flops, bytes_, peak=peaks[route])


def edge_latency_single_tile_terms(B: int, E: int, V: int,
                                   com_batch: int) -> RooflineTerms:
    """The least time for K4a, which runs K1's split-TF32 arithmetic:
    :func:`edge_latency_dense_terms`."""
    return edge_latency_dense_terms(B, E, V, com_batch)


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


def ssd_scan_bwd_terms(b: int, L: int, H: int, P: int, N: int, chunk: int,
                       dtype) -> RooflineTerms:
    """The least time for the gradient of the SSD chunked scan (K6's
    backward) on the operands of :func:`ssd_scan_terms` and dy of x's
    shape and ``dtype``.

    Operations, per (row, chunk) of Q = min(chunk, L) rows: ``2Q²N``
    (C·Bᵀ again, shared by the heads) + ``2Q(Q+1)·H·P`` (the
    lower-triangular dy·xᵀ and the dx it weights) + ``2Q(Q+1)·N`` (dG,
    summed over the heads, into dB and dC) + ``10QNHP`` (five state
    products: the chunk states recomputed, their gradients, and the state
    terms of dx, dB and dC), over ⌈L/Q⌉ chunks.  Bytes: x, dy, B, C and dt
    read once and dx, dB, dC and ddt written once (A, D read and dA, dD
    written).  The peak is the bf16 tensor-core rate for bf16 operands and
    the FP32 rate for float32 ones.  ``.bound_by`` says which limit
    binds."""
    width, peak = _operands(dtype, "SSD-scan")
    Q = max(min(chunk, L), 1)
    n = -(-L // Q)
    per_chunk = (2.0 * Q * Q * N + 2.0 * Q * (Q + 1.0) * H * P
                 + 2.0 * Q * (Q + 1.0) * N + 10.0 * Q * N * H * P)
    flops = b * n * per_chunk
    bytes_ = b * L * (3.0 * H * P * width + 4.0 * N * width + 8.0 * H) \
        + 16.0 * H
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


def rmsnorm_bwd_terms(rows: int, D: int, dtype) -> RooflineTerms:
    """The least time for RMSNorm's gradient on x (rows, D) of ``dtype``
    with a float32 weight: x and the upstream gradient read once, dx
    written once (``dtype``), w read and dw written once (float32); 10
    operations per element (x², x·g·w, g·w, dx's three, dw's two and the
    scaling) at the FP32 rate.  The kernel's dw partials (grid × D float32,
    written and read back) are its own overhead and not counted."""
    width, _ = _operands(dtype, "RMSNorm")
    flops = 10.0 * rows * D
    bytes_ = 3.0 * rows * D * width + 8.0 * D
    return compute_terms(flops, bytes_, peak=PEAK_FLOPS)
