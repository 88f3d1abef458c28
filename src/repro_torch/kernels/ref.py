"""Plain PyTorch versions of the edge-latency kernels.

The counterparts of ``repro.kernels.ref.edge_latency_ref`` and of the XLA
routes in ``repro.kernels.dispatch`` (``_edge_latency_xla``,
``_edge_latency_structured_xla``).  They compute in the dtype they are
given: the device policy sends CPU float32 tensors here, and
``chip_smoke.py`` holds the CUDA kernels against them in float64.  A shared
scenario (batch 1) goes through one product against its single matrix, so
it is never expanded to the placement batch.
"""

from __future__ import annotations

import torch

__all__ = ["edge_latency_dense_plain", "edge_latency_structured_plain"]


def _batched_product(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(B, E, K) @ (Bc, K, N) → (B, E, N) with Bc ∈ {1, B}."""
    if rhs.shape[0] == 1:
        return torch.matmul(lhs, rhs[0])
    return torch.bmm(lhs, rhs)


def edge_latency_dense_plain(x_i: torch.Tensor, x_j: torch.Tensor,
                             com: torch.Tensor) -> torch.Tensor:
    """(B, E, V) rows × (B|1, V, V) com → (B, E)
    ``max_u x_i[b,e,u]·Σ_v com[b,u,v]·x_j[b,e,v]``."""
    t = _batched_product(x_j, com.transpose(-1, -2))        # (B, E, V)
    return (x_i * t).amax(dim=-1)


def edge_latency_structured_plain(x_i: torch.Tensor, x_j: torch.Tensor,
                                  mass: torch.Tensor, a: torch.Tensor,
                                  corr: torch.Tensor) -> torch.Tensor:
    """x_i, x_j (B, E, V); mass (B, E, R); a (Bc, R, V); corr (Bc, 1, V)
    → (B, E) ``max_u x_i·(mass @ a + corr·x_j)``."""
    t = _batched_product(mass, a) + corr * x_j              # (B, E, V)
    return (x_i * t).amax(dim=-1)
