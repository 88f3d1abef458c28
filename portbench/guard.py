"""The check that nothing of JAX or of the JAX package was loaded.

A module is named by the part of its name before the first dot, compared
as a whole string: ``repro_torch.models`` is the port and passes,
``repro.core`` is the JAX package and is caught.
"""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The loaded modules among ``names`` (an iterable of module names, as
    ``sys.modules``' keys) whose top-level name is forbidden, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
