"""Cost-model-driven layout choice ("operator configuration", paper §1) —
the counterpart of ``repro.core.autoshard``, priced for H100 nodes.

For a given (architecture × input shape × device budget) the candidate
parallel layouts (DP × TP factorizations, vocab-parallel loss on or off,
remat policy) are scored with the same three-term roofline the dry run
reports, **pricing each collective on the link class it rides** — the
paper's geo-heterogeneity: DP traffic that crosses the ``pod`` axis pays
the network tier, TP traffic inside a pod pays the fast tier, and the
step's collective term is the slowest participant's total.

The formulas are the reference's, term for term.  Its TPU v5e constants
become the H100's, from the port's own device tables: HBM 3.35 TB/s and
989 TFLOP/s dense bf16 (``repro_torch.perf.roofline``), NVLink 450 GB/s
each way for the reference's ICI tier and the 50 GB/s network
(``repro_torch.core.devices.NET_GBPS``) for its DCI tier.  The field names
keep the reference's (``ici_collective_s``, ``dci_collective_s``).  The
estimates are analytic (bytes from model dims); the dry run
(``repro_torch.launch.dryrun``) re-derives the terms from a counted step.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.devices import NET_GBPS, NVLINK_GBPS
from repro_torch.perf.roofline import HBM_BW, PEAK_BF16_TC

__all__ = ["Layout", "LayoutEstimate", "candidate_layouts", "estimate_layout",
           "choose_layout", "PEAK_BF16_TFLOPS", "HBM_GBPS", "ICI_GBPS",
           "DCI_GBPS"]

# NVIDIA H100 80GB HBM3 (data sheet, SXM), in the reference's units
PEAK_BF16_TFLOPS = PEAK_BF16_TC / 1e12
HBM_GBPS = HBM_BW / 1e9
ICI_GBPS = NVLINK_GBPS     # inside a node: NVLink, each way
DCI_GBPS = NET_GBPS        # between nodes / pods: the network tier


@dataclasses.dataclass(frozen=True)
class Layout:
    dp: int  # data-parallel ways (including the pod axis)
    tp: int  # tensor/expert-parallel ways
    pods: int = 1
    vocab_parallel_ce: bool = True
    zero_sharded_opt: bool = True  # optimizer state sharded over dp
    remat: str = "full"  # "full" | "dots" | "none"

    @property
    def chips(self) -> int:
        return self.dp * self.tp


@dataclasses.dataclass
class LayoutEstimate:
    layout: Layout
    compute_s: float
    memory_s: float
    ici_collective_s: float
    dci_collective_s: float

    @property
    def collective_s(self) -> float:
        # DP grad sync can overlap across link classes only partially; be
        # conservative: serialize the two classes (slow path dominates).
        return self.ici_collective_s + self.dci_collective_s

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def candidate_layouts(chips: int, pods: int = 1,
                      max_tp: int = 64) -> list[Layout]:
    outs = []
    tp = 1
    while tp <= min(chips, max_tp):
        if chips % tp == 0:
            dp = chips // tp
            for vp in (True, False):
                for remat in ("full", "dots"):
                    outs.append(Layout(dp=dp, tp=tp, pods=pods,
                                       vocab_parallel_ce=vp, remat=remat))
        tp *= 2
    return outs


def _ring(n: int) -> float:
    return (n - 1) / n if n > 1 else 0.0


def estimate_layout(
    layout: Layout,
    *,
    n_layers: int,
    d_model: int,
    d_ff: int,
    vocab: int,
    seq: int,
    global_batch: int,
    n_params: float,
    moe_experts: int = 0,
    top_k: int = 2,
    train: bool = True,
    param_bytes: float = 4.0,
) -> LayoutEstimate:
    """Analytic roofline terms for one layout (per-device, bf16 activations)."""
    chips = layout.chips
    local_batch = global_batch / layout.dp
    tokens_local = local_batch * seq
    act = 2.0  # bf16 bytes

    # ---- compute (per device) ----
    n_active = n_params
    if moe_experts:
        # only top_k of the experts' FFN params are active per token
        ffn_params = n_layers * 3 * d_model * d_ff * moe_experts
        n_active = n_params - ffn_params + n_layers * 3 * d_model * d_ff * top_k
    flops_per_token = (6.0 if train else 2.0) * n_active
    # attention flops (quadratic term), causal halves it
    attn_flops_per_token = (6.0 if train else 2.0) * 2 * d_model * seq / 2
    remat_factor = {"full": 4.0 / 3.0, "dots": 7.0 / 6.0, "none": 1.0}[layout.remat]
    if not train:
        remat_factor = 1.0
    flops_dev = (flops_per_token + attn_flops_per_token) * tokens_local * remat_factor / layout.tp
    compute_s = flops_dev / (PEAK_BF16_TFLOPS * 1e12)

    # ---- HBM bytes (per device): params read + grads/opt + activations ----
    params_local = n_params * param_bytes / chips if layout.zero_sharded_opt \
        else n_params * param_bytes / layout.tp
    weight_traffic = n_params * param_bytes / layout.tp  # weights streamed per step
    act_traffic = tokens_local * d_model * act * n_layers * 8 / layout.tp
    opt_traffic = (3.0 if train else 0.0) * n_params * param_bytes / chips
    memory_s = (weight_traffic * (3.0 if train else 1.0) + act_traffic + opt_traffic) / (HBM_GBPS * 1e9)

    # ---- collectives per link class ----
    ici = 0.0
    dci = 0.0
    # TP: Megatron fwd+bwd all-reduces per layer: 4 × act bytes over tp (ICI)
    if layout.tp > 1:
        act_bytes = tokens_local * d_model * act
        per_layer = 4.0 * 2.0 * act_bytes * _ring(layout.tp)
        ici += n_layers * per_layer
        if not layout.vocab_parallel_ce:
            # all-gather full logits
            ici += tokens_local * vocab * act * _ring(layout.tp)
    if moe_experts and layout.tp > 1:
        # token dispatch+return all-to-all, fwd+bwd
        a2a = tokens_local * top_k * d_model * act * _ring(layout.tp)
        ici += 4.0 * a2a
    # DP grad reduce-scatter+all-gather: rides ICI within pod, DCI across pods
    if train and layout.dp > 1:
        grad_bytes = n_params * 2.0 / layout.tp  # bf16 grads
        wire = 2.0 * grad_bytes * _ring(layout.dp)
        if layout.pods > 1:
            intra = layout.dp // layout.pods
            # hierarchical: intra-pod reduce (ICI) + inter-pod exchange (DCI)
            ici += 2.0 * grad_bytes * _ring(intra)
            dci += 2.0 * (grad_bytes / max(intra, 1)) * _ring(layout.pods)
        else:
            ici += wire
    if train and layout.zero_sharded_opt and layout.dp > 1:
        # ZeRO-3 parameter all-gathers (fwd + bwd re-gather) over dp
        ici += 2.0 * (n_params * 2.0 / layout.tp) * _ring(layout.dp)
    ici_s = ici / (ICI_GBPS * 1e9)
    dci_s = dci / (DCI_GBPS * 1e9)
    return LayoutEstimate(layout, compute_s, memory_s, ici_s, dci_s)


def choose_layout(chips: int, pods: int = 1, **model_kwargs) -> LayoutEstimate:
    """argmin step-time over candidates; ties broken toward smaller TP
    (less collective surface) — the paper's optimizer role, analytically."""
    best = None
    for layout in candidate_layouts(chips, pods):
        est = estimate_layout(layout, **model_kwargs)
        if best is None or est.step_time_s < best.step_time_s - 1e-12 or (
                abs(est.step_time_s - best.step_time_s) <= 1e-12
                and layout.tp < best.layout.tp):
            best = est
    return best
