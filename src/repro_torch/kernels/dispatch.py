"""Device policy for the edge-latency hot path — the port's counterpart of
``repro.kernels.dispatch`` (``resolve_flags`` / ``plan_edge_kernel``).

The rule is the tensors' device, nothing else:

* a CUDA tensor goes to the CUDA C++ kernel (:mod:`.edge_latency`);
* a CPU tensor goes to the plain PyTorch version (:mod:`.ref`);
* any other device, or operands on different devices, raise.

There is no coercion and no fallback: a CUDA tensor reaches the kernel or
raises.  Block sizes are fixed constants of the kernel sources.  Every
decision is counted as ``kernels.dispatch.plans{kind, impl}`` in
:mod:`repro_torch.obs` when the registry is enabled.

:func:`resolve_device` is the policy for the public entry points
(``BatchedEvaluator``, ``WhatIfService``): ``None`` means the card, and a
machine without CUDA raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import edge_latency as kernels
from repro_torch.kernels import ref

__all__ = ["resolve_device", "plan_edge_kernel", "edge_latency",
           "edge_latency_structured"]


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


def plan_edge_kernel(kind: str, *tensors: torch.Tensor) -> str:
    """"cuda" or "plain" for these operands (see the module docstring)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kind} edge-latency operands span devices "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        impl = "cuda"
    elif dev.type == "cpu":
        impl = "plain"
    else:
        raise ValueError(f"no edge-latency route for device {dev}")
    reg = obs.registry()
    if reg.enabled:
        reg.counter("kernels.dispatch.plans", kind=kind, impl=impl).add(1)
    return impl


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
