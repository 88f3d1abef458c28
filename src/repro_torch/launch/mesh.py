"""Device meshes — the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default process
group, which the caller initialises (``init_process_group`` with its own
rendezvous, world size and rank: nothing on a machine tells a program of a
cluster).  The production shapes are the reference's, so the dry run's
cells are its cells: one pod (data = 16, model = 16), 256 devices, and two
pods (pod = 2, data = 16, model = 16), 512, whose ``pod`` axis is the
geo-distribution axis priced by the network tier
(``repro_torch.core.devices.fleet_from_gpu_mesh``).

A FUNCTION, not a module constant: importing this module touches no
process group.
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.models import sharding

__all__ = ["make_mesh", "use_mesh", "named_shardings", "make_production_mesh",
           "mesh_chips", "data_axes", "MODEL_AXIS"]

MODEL_AXIS = "model"


def make_mesh(shape, axes, device=None):
    """``init_device_mesh`` of ``shape`` named ``axes`` over the default
    process group, whose size must be the shape's product.  ``device``
    None means the card (raises without CUDA); ``"cpu"`` takes the CPU (a
    ``gloo`` or ``fake`` group)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.dispatch import resolve_device
    kind = resolve_device(device).type
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as this thread's ambient mesh (the one
    ``repro_torch.models.sharding.shard`` reads) inside the block; the one
    before it is restored after.  Inside it a plain tensor meeting a
    DTensor in an op (a rotary table, a mask, a scalar) is taken as
    replicated (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    saved = sharding.active_mesh()
    sharding._set_active_mesh(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        sharding._set_active_mesh(saved)


def named_shardings(mesh, spec_tree):
    """Spec tree → DTensor placements tree (a mapping's or a sequence's
    structure is kept; a :class:`~repro_torch.models.sharding.P` is a
    leaf)."""
    if isinstance(spec_tree, sharding.P):
        return sharding.placements(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: named_shardings(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        out = [named_shardings(mesh, v) for v in spec_tree]
        if hasattr(spec_tree, "_fields"):           # a NamedTuple
            return type(spec_tree)(*out)
        return type(spec_tree)(out)
    if spec_tree is None:
        return sharding.placements(sharding.P(), mesh)
    if dataclasses.is_dataclass(spec_tree):
        return type(spec_tree)(**{
            f.name: named_shardings(mesh, getattr(spec_tree, f.name))
            for f in dataclasses.fields(spec_tree)})
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_chips(mesh) -> int:
    n = 1
    for s in sharding.mesh_axes(mesh).values():
        n *= s
    return n


def data_axes(mesh) -> tuple[str, ...]:
    names = sharding.mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
