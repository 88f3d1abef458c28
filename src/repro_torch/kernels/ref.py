"""Plain PyTorch versions of the port's kernels.

* The edge-latency maxes: the counterparts of
  ``repro.kernels.ref.edge_latency_ref`` and of the XLA routes in
  ``repro.kernels.dispatch`` (``_edge_latency_xla``,
  ``_edge_latency_structured_xla``), also the plain versions of the
  whole-V single-tile kernels, which compute the same functions.  They compute in the dtype they are
  given.  A shared scenario (batch 1) goes through one product against its
  single matrix, so it is never expanded to the placement batch.
* Attention (:func:`flash_attention_plain`): the function
  ``repro.kernels.flash_attention._flash_kernel`` computes, as one full
  softmax.  It computes in float32 for float32 / bfloat16 inputs and in
  float64 for float64 inputs.
* RMSNorm (:func:`rmsnorm_plain`): ``repro.models.layers.rms_norm``, the
  function ``repro.kernels.rmsnorm._rmsnorm_kernel`` computes; its
  gradient (:func:`rmsnorm_bwd_plain`) is autograd through it, what the
  reference's ``jax.vjp`` of ``rms_norm`` computes.
* The SSD scan (:func:`ssd_scan_plain`): the chunked form of
  ``repro.models.mamba2.ssd_chunked`` (what ``_ssd_kernel`` computes),
  returning y, and on request the final state too.  Like the attention version it computes in float32, or in
  float64 for float64 inputs.

The device policy sends CPU tensors here, and ``chip_smoke.py`` holds the
CUDA kernels against these versions on the card (float64 for float32
kernels).
"""

from __future__ import annotations

import torch

__all__ = ["edge_latency_dense_plain", "edge_latency_structured_plain",
           "edge_latency_dense_single_tile_plain",
           "edge_latency_structured_single_tile_plain",
           "check_attention_operands", "flash_attention_plain",
           "rmsnorm_plain", "rmsnorm_bwd_plain", "check_ssd_operands",
           "ssd_scan_plain"]

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


def edge_latency_dense_single_tile_plain(x_i, x_j, com) -> torch.Tensor:
    """K4a's plain version.  The whole-V kernel computes K1's function, so
    this is :func:`edge_latency_dense_plain` under K4a's name."""
    return edge_latency_dense_plain(x_i, x_j, com)


def edge_latency_structured_single_tile_plain(x_i, x_j, mass, a,
                                              corr) -> torch.Tensor:
    """K4b's plain version: K2's function, so this is
    :func:`edge_latency_structured_plain` under K4b's name."""
    return edge_latency_structured_plain(x_i, x_j, mass, a, corr)


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


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor | None,
                  eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·weight`` over the last axis in float32
    (float64 for float64 x), in x's dtype; no weight when ``None``."""
    dt = x.dtype
    x = x.float() if dt != torch.float64 else x
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.to(x.dtype)
    return x.to(dt)


def rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw): the gradient of :func:`rmsnorm_plain` (x, w) against the
    upstream gradient g, by autograd through it — dx in x's dtype, dw in
    w's."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_()
        wd = w.detach().requires_grad_()
        dx, dw = torch.autograd.grad(rmsnorm_plain(xd, wd, eps), (xd, wd), g)
    return dx, dw


def check_ssd_operands(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       chunk: int) -> tuple[int, int, int, int, int, int]:
    """Raise unless x (b, L, H, P), B and C (b, L, N) of one dtype, dt
    (b, L, H), A and D (H,) agree and ``chunk`` ≥ 1; return
    (b, L, H, P, N, Q) with Q = min(chunk, L), the reference's chunk."""
    if x.dim() != 4 or B.dim() != 3 or C.shape != B.shape or dt.dim() != 3:
        raise ValueError(f"SSD scan wants x (b, L, H, P), B/C (b, L, N), dt "
                         f"(b, L, H); got {tuple(x.shape)}, {tuple(B.shape)},"
                         f" {tuple(C.shape)}, {tuple(dt.shape)}")
    b, L, H, P = x.shape
    N = B.shape[-1]
    if tuple(B.shape[:2]) != (b, L) or tuple(dt.shape) != (b, L, H) \
            or tuple(A.shape) != (H,) or tuple(D.shape) != (H,):
        raise ValueError(f"SSD operands disagree: x {tuple(x.shape)}, B/C "
                         f"{tuple(B.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}")
    if not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"x, B, C dtypes differ: {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return b, L, H, P, N, max(min(chunk, L), 1)


def ssd_scan_plain(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   chunk: int, final_state: bool = False,
                   state_out: torch.Tensor | None = None):
    """The chunked SSD scan of ``repro.models.mamba2.ssd_chunked``: chunks
    of Q = min(chunk, L) rows, a ragged last chunk zero-padded, per chunk
    the intra-chunk form ``(C·Bᵀ ⊙ exp(cum_i − cum_j) ⊙ dt_j)·x`` masked to
    j ≤ i, the carried term ``exp(cum_i)·C_i·S``, ``D·x`` and the state
    update, op for op.  Returns y (b, L, H, P) in x's dtype, or with
    ``final_state`` the pair (y, S) with S (b, H, N, P) the state after
    the last row, as ``ssd_chunked`` returns it (float32; float64 for
    float64 inputs).  ``state_out`` (b, H, N, P) receives S and is
    returned in its place (it implies ``final_state``)."""
    if state_out is not None:
        y, S = ssd_scan_plain(x, B, C, dt, A, D, chunk, True)
        return y, state_out.copy_(S)
    b, L, H, Pd, N, Q = check_ssd_operands(x, B, C, dt, A, D, chunk)
    ct = torch.promote_types(x.dtype, torch.float32)
    n = -(-L // Q)
    S = torch.zeros((b, H, N, Pd), dtype=ct, device=x.device)
    if n == 0:
        y = torch.empty((b, 0, H, Pd), dtype=x.dtype, device=x.device)
        return (y, S) if final_state else y
    pad = n * Q - L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    A, D, dt = A.to(ct), D.to(ct), dt.to(ct)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(n):
        rows = slice(c * Q, (c + 1) * Q)
        x_c, B_c, C_c = x[:, rows], B[:, rows], C[:, rows]
        dt_c = dt[:, rows]                                    # (b, Q, H)
        xf = x_c.to(ct)
        cum = torch.cumsum(dt_c * A, dim=1)                   # (b, Q, H)
        total = cum[:, -1, :]                                 # (b, H)
        CB = torch.einsum("biN,bjN->bij", C_c.to(ct), B_c.to(ct))
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        M = CB[..., None] * torch.where(mask[None, :, :, None], decay,
                                        0.0) * dt_c[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", M, xf)
        y = y + torch.einsum("biN,bhNp->bihp", C_c.to(ct), S) \
            * torch.exp(cum)[..., None]
        w = torch.exp(total[:, None, :] - cum) * dt_c         # (b, Q, H)
        S = torch.exp(total)[..., None, None] * S + torch.einsum(
            "bjN,bjh,bjhp->bhNp", B_c.to(ct), w, xf)
        y = y + D[None, None, :, None] * xf
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :L]
    return (y, S) if final_state else y
