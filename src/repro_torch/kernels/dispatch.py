"""Device policy for the port's kernels — the counterpart of
``repro.kernels.dispatch`` (``resolve_flags`` / ``plan_edge_kernel``) and
of the model layer's ``attention_impl="pallas"`` route
(``repro.kernels.ops.flash_attention``).

The rule is the tensors' device, nothing else:

* a CUDA tensor goes to the CUDA C++ kernel (:mod:`.edge_latency`,
  :mod:`.flash_attention`, :mod:`.rmsnorm`, :mod:`.ssd_scan`);
* a CPU tensor goes to the plain PyTorch version (:mod:`.ref`);
* any other device, or operands on different devices, raise.

There is no coercion and no fallback: a CUDA tensor reaches the kernel or
raises.  Block sizes are fixed constants of the kernel sources.  Every
decision is counted as ``kernels.dispatch.plans{kind, impl}`` in
:mod:`repro_torch.obs` when the registry is enabled (kind ``dense``,
``structured``, ``dense_single_tile``, ``structured_single_tile``,
``flash_attention``, ``rmsnorm`` or ``ssd_scan``).

The single-tile routes (K4a, K4b) are the whole-V references the blocked
kernels are held against; as in the reference, no path of the system
reaches them.

:func:`resolve_device` is the policy for the public entry points
(``BatchedEvaluator``, ``WhatIfService``, ``build_model``): ``None`` means
the card, and a machine without CUDA raises instead of quietly running on
the CPU.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import edge_latency as kernels
from repro_torch.kernels import flash_attention as attention_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.kernels import ssd_scan as ssd_kernel

__all__ = ["resolve_device", "plan_edge_kernel", "plan_attention_kernel",
           "edge_latency", "edge_latency_structured",
           "edge_latency_single_tile", "edge_latency_structured_single_tile",
           "flash_attention", "rmsnorm", "ssd_scan"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device.  Raises RuntimeError when CUDA is
    asked for (explicitly or by default) and unavailable; the CPU is used
    only when the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _plan(kind: str, what: str, tensors) -> str:
    """"cuda" or "plain" for these operands (see the module docstring)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kind} {what} operands span devices "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        impl = "cuda"
    elif dev.type == "cpu":
        impl = "plain"
    else:
        raise ValueError(f"no {what} route for device {dev}")
    reg = obs.registry()
    if reg.enabled:
        reg.counter("kernels.dispatch.plans", kind=kind, impl=impl).add(1)
    return impl


def plan_edge_kernel(kind: str, *tensors: torch.Tensor) -> str:
    """"cuda" or "plain" for edge-latency operands of ``kind`` ("dense",
    "structured", "dense_single_tile" or "structured_single_tile")."""
    return _plan(kind, "edge-latency", tensors)


def plan_attention_kernel(*tensors: torch.Tensor) -> str:
    """"cuda" or "plain" for attention operands."""
    return _plan("flash_attention", "flash-attention", tensors)


def edge_latency(x_i, x_j, com) -> torch.Tensor:
    """Dense edge-latency max: (B, E, V) rows × (B|1, V, V) com → (B, E)."""
    if plan_edge_kernel("dense", x_i, x_j, com) == "cuda":
        return kernels.edge_latency_dense(x_i, x_j, com)
    return ref.edge_latency_dense_plain(x_i, x_j, com)


def edge_latency_structured(x_i, x_j, mass, a, corr) -> torch.Tensor:
    """Structured (RegionFleet) edge-latency max:
    ``max_u x_i·(mass @ a + corr·x_j)`` → (B, E)."""
    if plan_edge_kernel("structured", x_i, x_j, mass, a, corr) == "cuda":
        return kernels.edge_latency_structured(x_i, x_j, mass, a, corr)
    return ref.edge_latency_structured_plain(x_i, x_j, mass, a, corr)


def edge_latency_single_tile(x_i, x_j, com) -> torch.Tensor:
    """K1's function through the whole-V kernel (K4a) on the card, its
    plain version on the CPU."""
    if plan_edge_kernel("dense_single_tile", x_i, x_j, com) == "cuda":
        return kernels.edge_latency_dense_single_tile(x_i, x_j, com)
    return ref.edge_latency_dense_single_tile_plain(x_i, x_j, com)


def edge_latency_structured_single_tile(x_i, x_j, mass, a,
                                        corr) -> torch.Tensor:
    """K2's function through the whole-V kernel (K4b) on the card, its
    plain version on the CPU."""
    if plan_edge_kernel("structured_single_tile", x_i, x_j, mass, a,
                        corr) == "cuda":
        return kernels.edge_latency_structured_single_tile(x_i, x_j, mass, a,
                                                           corr)
    return ref.edge_latency_structured_single_tile_plain(x_i, x_j, mass, a,
                                                         corr)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) attention with kv repeated to H → (B, S, H, D) in q's
    dtype: K5 on the card, its plain version on the CPU."""
    if plan_attention_kernel(q, k, v) == "cuda":
        return attention_kernel.flash_attention(q, k, v, causal=causal)
    return ref.flash_attention_plain(q, k, v, causal=causal)


def rmsnorm(x, w, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the last axis with a weight, in x's dtype: K7 on the
    card, its plain version on the CPU.  The weight is read as float32."""
    if _plan("rmsnorm", "rmsnorm", (x, w)) == "cuda":
        return rmsnorm_kernel.rmsnorm(x, w.float(), eps)
    return ref.rmsnorm_plain(x, w, eps)


def ssd_scan(x, B, C, dt, A, D, chunk: int, final_state: bool = False,
             state_out=None):
    """The Mamba2 SSD chunked scan → y (b, L, H, P) in x's dtype, or
    (y, final state (b, H, N, P) float32) with ``final_state`` or a
    ``state_out`` to write it into: K6 on the card, its plain version on
    the CPU."""
    into = {} if state_out is None else {"state_out": state_out}
    if _plan("ssd_scan", "SSD-scan", (x, B, C, dt, A, D)) == "cuda":
        return ssd_kernel.ssd_scan(x, B, C, dt, A, D, chunk, final_state,
                                   **into)
    return ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, final_state, **into)
