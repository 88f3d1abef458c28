"""Mamba2 (arXiv:2405.21060): its weight tree, its layer in plain float32
PyTorch, and its frozen count of model FLOPs.

The weights are those of ``src/repro_torch/models/mamba2.py:139-158`` at
the port's initial scales: normal × fan_in^-½, the conv × k^-½, zero conv
bias, A_log = log(linspace(1, 16, H)), D = 1, dt_bias = −2, norm weights
1, one group of B and C shared by the heads.

The layer is the model's as the port defines it (``mamba2.py``,
``layers.py``): h = RMSNorm(x); z, x', B, C = h·W; dt = softplus(h·W_dt +
dt_bias); a causal depthwise conv of k taps with bias over [x', B, C], then
SiLU; the SSD scan y_t = Σ_{s≤t} (C_t·B_s) exp(Σ_{s<r≤t} dt_r A) dt_s x_s
+ D x_t with A = −exp(A_log), exact in chunks of the published chunk;
y ⊙ SiLU(z), RMSNorm over d_inner, the out projection, the residual.

The count follows ``src/repro_torch/models/api.py:168-257``
(``count_params`` / ``analytic_flops``) without its fault: the embedding
lookup is no matmul and is not counted.  The scan is counted as
:func:`portbench.counts.ssd_scan_terms` counts it; a training step counts
each matmul three times (forward, the two products of its backward) and
the scan's backward by :func:`portbench.counts.ssd_scan_bwd_terms`;
recomputation is not counted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.counts import ssd_scan_bwd_terms, ssd_scan_terms, ssm_shape
from portbench.reference.lm import rms
from portbench.weights import padded_vocab


def groups(model: dict) -> list[str]:
    return ["embed"] + [f"blocks.{i}" for i in range(model["n_layers"])] \
        + ["head"]


def leaves(model: dict, group: str) -> list[tuple[str, tuple, tuple]]:
    d, vp = model["d_model"], padded_vocab(model)
    if group == "embed":
        return [("embed", (vp, d), ("normal", d ** -0.5))]
    if group == "head":
        return [("final_norm", (d,), ("const", 1.0)),
                ("head", (d, vp), ("normal", d ** -0.5))]
    s = ssm_shape(model)
    di, N, H, k = s["d_inner"], s["N"], s["H"], model["ssm_conv"]
    p = group + "."
    return [(p + "norm", (d,), ("const", 1.0)),
            (p + "wz", (d, di), ("normal", d ** -0.5)),
            (p + "wx", (d, di), ("normal", d ** -0.5)),
            (p + "wB", (d, N), ("normal", d ** -0.5)),
            (p + "wC", (d, N), ("normal", d ** -0.5)),
            (p + "wdt", (d, H), ("normal", d ** -0.5)),
            (p + "conv_w", (k, di + 2 * N), ("normal", k ** -0.5)),
            (p + "conv_b", (di + 2 * N,), ("const", 0.0)),
            (p + "A_log", (H,), ("log_linspace", 1.0, 16.0)),
            (p + "D", (H,), ("const", 1.0)),
            (p + "dt_bias", (H,), ("const", -2.0)),
            (p + "gate_norm", (di,), ("const", 1.0)),
            (p + "out_proj", (di, d), ("normal", di ** -0.5))]


def ssd(x, B, C, dt, A, D, chunk: int) -> torch.Tensor:
    """The SSD scan, x (b, L, H, P), B and C (b, L, N), dt (b, L, H), A and
    D (H,) → y (b, L, H, P), exact in chunks of ``chunk`` rows: in a
    chunk the decays exp(cum_i − cum_j) for j ≤ i (the difference masked to
    −inf above the diagonal before the exponential), the state carried in
    from the chunks before, and the state passed on."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = max(min(chunk, L), 1)
    n = -(-L // Q)
    pad = n * Q - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    S = x.new_zeros((b, H, N, P))
    ys = []
    for c in range(n):
        rows = slice(c * Q, (c + 1) * Q)
        xc, Bc, Cc, dtc = x[:, rows], B[:, rows], C[:, rows], dt[:, rows]
        cum = torch.cumsum(dtc * A, dim=1)                       # (b, Q, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # i, j
        decay = torch.exp(diff.masked_fill(~mask[None, :, :, None],
                                           float("-inf")))
        M = torch.einsum("biN,bjN->bij", Cc, Bc)[..., None] * decay \
            * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", M, xc)
        y = y + torch.einsum("biN,bhNp->bihp", Cc, S) \
            * torch.exp(cum)[..., None]
        last = cum[:, -1]                                        # (b, H)
        wgt = torch.exp(last[:, None, :] - cum) * dtc
        S = torch.exp(last)[..., None, None] * S \
            + torch.einsum("bjN,bjh,bjhp->bhNp", Bc, wgt, xc)
        ys.append(y + D[None, None, :, None] * xc)
    return torch.cat(ys, dim=1)[:, :L]


def mamba_layer(w: dict, x: torch.Tensor, model: dict, r) -> torch.Tensor:
    """One Mamba2 layer."""
    b, L, _ = x.shape
    s = ssm_shape(model)
    di, N, H, P = s["d_inner"], s["N"], s["H"], s["P"]

    def mm(a, W):
        return r(a @ r(W))

    h = r(rms(x, w["norm"]))
    z, xi = mm(h, w["wz"]), mm(h, w["wx"])
    Bi, Ci = mm(h, w["wB"]), mm(h, w["wC"])
    dt = F.softplus(h @ w["wdt"] + w["dt_bias"])
    u = torch.cat([xi, Bi, Ci], dim=-1)
    k = w["conv_w"].shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    conv = up[:, 0:L] * w["conv_w"][0]
    for i in range(1, k):
        conv = conv + up[:, i:i + L] * w["conv_w"][i]
    conv = r(F.silu(conv + w["conv_b"]))
    xs = conv[..., :di].reshape(b, L, H, P)
    A = -torch.exp(w["A_log"])
    y = r(ssd(xs, conv[..., di:di + N], conv[..., di + N:], dt, A, w["D"],
              s["chunk"]))
    y = r(y.reshape(b, L, di) * r(F.silu(z)))
    y = r(rms(y, w["gate_norm"]))
    return r(x + mm(y, w["out_proj"]))


def layers(model: dict) -> list:
    return [(f"blocks.{i}", mamba_layer) for i in range(model["n_layers"])]


def matmul_params(model: dict) -> int:
    """Weights a token multiplies once in a forward: every projection and
    the head (true vocabulary); no embedding, no depthwise conv, no
    norm."""
    d = model["d_model"]
    s = ssm_shape(model)
    per_layer = d * (2 * s["d_inner"] + 2 * s["N"] + s["H"]) \
        + s["d_inner"] * d
    return model["n_layers"] * per_layer + d * model["vocab"]


def model_flops(model: dict, seqs: int, seq_len: int, mode: str) -> float:
    tokens = seqs * seq_len
    s = ssm_shape(model)
    args = (seqs, seq_len, s["H"], s["P"], s["N"], s["chunk"],
            model["act_dtype"])
    fwd_scan = ssd_scan_terms(*args).flops * model["n_layers"]
    mm = 2.0 * matmul_params(model) * tokens
    if mode == "forward":
        return mm + fwd_scan
    if mode != "train":
        raise ValueError(f"mode is 'forward' or 'train', got {mode!r}")
    bwd_scan = ssd_scan_bwd_terms(*args).flops * model["n_layers"]
    return 3.0 * mm + fwd_scan + bwd_scan
