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
  float64 for float64 inputs.  Its decays are formed only on and below
  the diagonal (:func:`_decay`), so autograd through it stays finite
  where the reference's ``jax.grad`` is not (the reference exponentiates
  every in-chunk difference before masking; above the diagonal they
  overflow float32 at the published chunk of 256).  Its gradient
  (:func:`ssd_scan_bwd_plain`) is written out by hand, chunk by chunk in
  reverse, the function K6's backward kernel computes.

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
           "ssd_scan_plain", "ssd_scan_bwd_plain"]

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


def _decay(cum: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``exp(cum_i − cum_j)`` (b, i, j, H) for j ≤ i and 0 above the
    diagonal, where the difference is set to −inf before the exponential:
    an exponential of the positive differences there would overflow, and
    its gradient times the mask's zero would be NaN."""
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    return torch.exp(diff.masked_fill(~mask[None, :, :, None], float("-inf")))


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
        M = CB[..., None] * _decay(cum, mask) * dt_c[:, None, :, :]
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


def ssd_scan_bwd_plain(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor, chunk: int):
    """The gradient of :func:`ssd_scan_plain`'s y against the upstream
    gradient dy (b, L, H, P) → (dx, dB, dC, ddt, dA, dD), each in its
    operand's dtype, written out by hand (the final state is not
    differentiated).  Per chunk c, with a_j = dt_j·A, cum its in-chunk
    cumsum, total = cum_{Q−1}, L_ij = exp(cum_i − cum_j) on and below the
    diagonal, G = C·Bᵀ and S_c the state carried into the chunk:

    * the states, forward: S_{c+1} = exp(total)·S_c + Σ_j w_j B_j ⊗ x_j
      with w_j = exp(total − cum_j)·dt_j; their gradients, in reverse from
      dS_n = 0: dS_c = exp(total)·dS_{c+1} + Σ_i exp(cum_i)·C_i ⊗ dy_i;
    * dx_j = dt_j Σ_{i≥j} G_ij L_ij dy_i + w_j B_j·dS_{c+1} + D·dy_j;
    * dG_ij = Σ_h L_ij dt_j (dy_i·x_j), so dC_i = Σ_j dG_ij B_j +
      Σ_h exp(cum_i) S_c dy_i and dB_j = Σ_i dG_ij C_i + Σ_h w_j dS_{c+1} x_j
      (B and C are shared by the heads);
    * ddt_j: Σ_i G_ij L_ij (dy_i·x_j) + exp(total − cum_j)·(B_j·dS_{c+1}
      x_j) + A·da_j, where da is the in-chunk reverse cumsum of dcum and
      total's gradient joins dcum at the chunk's last row;
    * dA = Σ dt_j·da_j and dD = Σ x·dy over batch and rows.

    It computes in float32, or in float64 for float64 inputs, takes the
    strided views and the ragged L :func:`ssd_scan_plain` takes (the
    padded rows have dt 0, so they add nothing)."""
    b, L, H, Pd, N, Q = check_ssd_operands(x, B, C, dt, A, D, chunk)
    if tuple(dy.shape) != (b, L, H, Pd):
        raise ValueError(f"dy {tuple(dy.shape)} must be y's shape "
                         f"{(b, L, H, Pd)}")
    ct = torch.promote_types(x.dtype, torch.float32)
    n = -(-L // Q)
    f = dict(dtype=ct, device=x.device)
    dA = torch.zeros(H, **f)
    dD = torch.zeros(H, **f)
    if n == 0 or b == 0:
        return (torch.zeros_like(x), torch.zeros_like(B), torch.zeros_like(C),
                torch.zeros_like(dt), dA.to(A.dtype), dD.to(D.dtype))
    pad = n * Q - L
    ops = [x, B, C, dt, dy]
    if pad:
        ops = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
               for t in ops]
    x, B, C, dt, dy = (t.to(ct) for t in ops)
    Af, Df = A.to(ct), D.to(ct)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    rows = [slice(c * Q, (c + 1) * Q) for c in range(n)]
    cums, states = [], []
    S = torch.zeros((b, H, N, Pd), **f)
    for r in rows:                       # the states carried into chunks
        cum = torch.cumsum(dt[:, r] * Af, dim=1)               # (b, Q, H)
        total = cum[:, -1]
        cums.append(cum)
        states.append(S)
        w = torch.exp(total[:, None] - cum) * dt[:, r]
        S = torch.exp(total)[..., None, None] * S + torch.einsum(
            "bjN,bjh,bjhp->bhNp", B[:, r], w, x[:, r])
    dx, dB, dC, ddt = (torch.empty_like(t) for t in (x, B, C, dt))
    dS = torch.zeros((b, H, N, Pd), **f)                       # dS_{c+1}
    for c in reversed(range(n)):
        r, cum, S = rows[c], cums[c], states[c]
        x_c, B_c, C_c, dt_c, dy_c = x[:, r], B[:, r], C[:, r], dt[:, r],             dy[:, r]
        total = cum[:, -1]
        Lm = _decay(cum, mask)                                 # (b, i, j, H)
        dot = torch.einsum("bihp,bjhp->bijh", dy_c, x_c)
        R = torch.einsum("biN,bjN->bij", C_c, B_c)[..., None] * Lm
        RD = R * dot
        dG = (Lm * dt_c[:, None] * dot).sum(-1)                # (b, i, j)
        cols = RD.sum(1)                                       # (b, j, H)
        dcum = (RD * dt_c[:, None]).sum(2) - dt_c * cols
        g_dt = cols
        g_x = torch.einsum("bijh,bihp->bjhp", R, dy_c) * dt_c[..., None]
        g_C = torch.einsum("bij,bjN->biN", dG, B_c)
        g_B = torch.einsum("bij,biN->bjN", dG, C_c)
        e = torch.exp(cum)                                     # exp(cum_i)
        W = torch.einsum("bihp,bhNp->bihN", dy_c, S)
        g_C = g_C + torch.einsum("bih,bihN->biN", e, W)
        dcum = dcum + e * torch.einsum("biN,bihN->bih", C_c, W)
        decay = torch.exp(total[:, None] - cum)
        w = decay * dt_c
        V = torch.einsum("bjhp,bhNp->bjhN", x_c, dS)
        g_x = g_x + w[..., None] * torch.einsum("bjN,bhNp->bjhp", B_c, dS)
        g_B = g_B + torch.einsum("bjh,bjhN->bjN", w, V)
        dw = torch.einsum("bjN,bjhN->bjh", B_c, V)
        g_dt = g_dt + decay * dw
        dcum = dcum - w * dw
        dtotal = (w * dw).sum(1) + torch.exp(total) * (S * dS).sum((-2, -1))
        dcum[:, -1] += dtotal
        da = dcum.flip(1).cumsum(1).flip(1)
        dx[:, r] = g_x + Df[:, None] * dy_c
        dB[:, r], dC[:, r] = g_B, g_C
        ddt[:, r] = g_dt + Af * da
        dA = dA + (dt_c * da).sum((0, 1))
        dD = dD + (x_c * dy_c).sum((0, 1, 3))
        dS = torch.exp(total)[..., None, None] * dS + torch.einsum(
            "bih,biN,bihp->bhNp", e, C_c, dy_c)
    return (dx[:, :L].to(ops[0].dtype), dB[:, :L].to(ops[1].dtype),
            dC[:, :L].to(ops[2].dtype), ddt[:, :L].to(ops[3].dtype),
            dA.to(A.dtype), dD.to(D.dtype))
