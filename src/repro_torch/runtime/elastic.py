"""Elastic scaling for the training path: survive the loss of a pod or a
node — the counterpart of ``repro.runtime.elastic``.

Strategy (checkpoint-restart based, the only sound one for synchronous
SPMD): on failure, rebuild a smaller mesh from the surviving devices,
restore the latest checkpoint host-side (runtime/checkpoint restores are
mesh-portable), rescale the global batch to keep per-device work constant
(or keep global batch and raise grad-accumulation), and continue.

``plan_rescale`` computes the new run configuration (the reference's
arithmetic); ``rebuild_mesh`` builds the smaller ("data", "model")
``DeviceMesh`` over a process group re-initialised with the survivors.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RescalePlan", "plan_rescale", "rebuild_mesh"]


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_devices: int
    new_devices: int
    data_ways: int
    model_ways: int
    global_batch: int
    grad_accum: int
    note: str


def rebuild_mesh(n_devices: int, model_ways: int, device=None):
    """A (n_devices / model_ways, model_ways) ("data", "model") mesh over the
    default process group, whose size must be ``n_devices``; ``device``
    as ``repro_torch.launch.mesh.make_mesh``."""
    if n_devices % model_ways:
        raise ValueError(f"{n_devices} devices not divisible by model={model_ways}")
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((n_devices // model_ways, model_ways), ("data", "model"),
                     device)


def plan_rescale(old_devices: int, surviving: int, model_ways: int,
                 global_batch: int, keep_global_batch: bool = True) -> RescalePlan:
    """Largest usable device count = biggest multiple of model_ways ≤
    surviving (tensor-parallel groups must stay whole)."""
    usable = (surviving // model_ways) * model_ways
    if usable == 0:
        raise ValueError("not enough devices for one tensor-parallel group")
    data_ways = usable // model_ways
    if keep_global_batch:
        # keep optimization trajectory comparable: same global batch, more
        # grad accumulation when per-device batch would not divide
        accum = 1
        while global_batch % (data_ways * accum) or \
                (global_batch // (data_ways * accum)) > 4096:
            accum += 1
            if accum > global_batch:
                accum = 1
                break
        gb = global_batch
        note = f"kept global batch; grad_accum={accum}"
    else:
        gb = max((global_batch * usable) // old_devices, data_ways)
        gb -= gb % data_ways
        accum = 1
        note = "scaled global batch with device count"
    return RescalePlan(old_devices, usable, data_ways, model_ways, gb, accum,
                       note)
