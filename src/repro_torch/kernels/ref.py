"""Plain PyTorch versions of the port's kernels.

* The edge-latency maxes: the counterparts of
  ``repro.kernels.ref.edge_latency_ref`` and of the XLA routes in
  ``repro.kernels.dispatch`` (``_edge_latency_xla``,
  ``_edge_latency_structured_xla``).  They compute in the dtype they are
  given.  A shared scenario (batch 1) goes through one product against its
  single matrix, so it is never expanded to the placement batch.
* Attention (:func:`flash_attention_plain`): the function
  ``repro.kernels.flash_attention._flash_kernel`` computes, as one full
  softmax.  It computes in float32 for float32 / bfloat16 inputs and in
  float64 for float64 inputs.

The device policy sends CPU tensors here, and ``chip_smoke.py`` holds the
CUDA kernels against these versions on the card (float64 for float32
kernels).
"""

from __future__ import annotations

import torch

__all__ = ["edge_latency_dense_plain", "edge_latency_structured_plain",
           "check_attention_operands", "flash_attention_plain"]

# the reference kernel's mask value (repro.kernels.flash_attention.NEG_INF)
# and the floor of its softmax denominator
ATTN_NEG = -1e30
ATTN_L_FLOOR = 1e-30


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


def check_attention_operands(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool) -> None:
    """Raise unless q (B, Sq, H, D) and k, v (B, Skv, H, D) agree, and
    Sq == Skv when causal.  The reference kernel aligns its causal mask at
    position 0 while ``repro.kernels.ref.flash_attention_ref`` aligns it at
    the end (``tril(k=Skv-Sq)``); the two agree only for Sq == Skv, the
    only shape the model's attention sends."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention wants q (B, Sq, H, D) and k, v "
                         f"(B, Skv, H, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, heads (repeat kv to "
                         f"H first) or head dim")
    if k.shape[1] == 0 and Sq:
        raise ValueError("attention needs at least one key")
    if causal and k.shape[1] != Sq:
        raise ValueError(f"causal attention needs Sq == Skv, got Sq={Sq}, "
                         f"Skv={k.shape[1]} (the reference kernel's mask is "
                         f"aligned at 0, its oracle's at the end)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q, k, v (B, S, H, D), kv repeated to H → (B, S, H, D) in q's dtype:
    ``softmax(q·kᵀ·D^-½ masked k_pos ≤ q_pos) · v`` with the mask value
    −1e30 and the denominator floored at 1e-30, as the reference kernel."""
    check_attention_operands(q, k, v, causal)
    ct = torch.promote_types(q.dtype, torch.float32)
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * D ** -0.5
    if causal:
        S = q.shape[1]
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, ATTN_NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(ATTN_L_FLOOR)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.to(ct))
    return (acc / l).transpose(1, 2).to(q.dtype)
