"""Roofline terms on one NVIDIA H100 — the port's own ``compute_terms``,
which the serving layer's admission pricer runs its FLOP/byte counts
through (``repro_torch.serve.admission``).

  compute_s = FLOPs / PEAK_FLOPS
  memory_s  = bytes / HBM_BW

The edge-latency kernels compute in full FP32 on the CUDA cores (TF32
tensor cores miss the 1e-5 accuracy bar), so the compute peak is the FP32
non-tensor rate.  The rates are NVIDIA's data-sheet numbers for the SXM
part at its full power limit; a card capped lower runs slower under load,
which the pricer's observed/bound calibration absorbs.  The reference's
collective (ICI) term has no user in this single-card slice.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): FP32 without tensor cores
PEAK_FLOPS = 67e12
# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM): HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12

__all__ = ["RooflineTerms", "compute_terms", "PEAK_FLOPS", "HBM_BW"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def step_time_s(self) -> float:
        """Lower-bound time: the larger term (perfect overlap)."""
        return max(self.compute_s, self.memory_s)


def compute_terms(flops: float, bytes_: float) -> RooflineTerms:
    """Roofline terms for ``flops`` operations and ``bytes_`` of device
    memory traffic on one card."""
    return RooflineTerms(compute_s=flops / PEAK_FLOPS,
                         memory_s=bytes_ / HBM_BW)
