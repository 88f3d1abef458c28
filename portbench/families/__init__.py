"""Model families, one file each, found by the ``family`` of a
configuration's ``model``: ``families/<family>.py``.

A family file holds what the yardstick knows of one kind of model, so that
a configuration of a new family is added with a file and not by editing
the shared code:

* ``groups(model) -> list[str]``: the groups of its weights in order; the
  first is ``"embed"`` (the leaf ``embed``) and the last ``"head"`` (the
  leaves ``final_norm`` and ``head``);
* ``leaves(model, group) -> [(name, shape, init)]``: each leaf of a group,
  named as the program's ``named_parameters()`` names it; init is
  ``("normal", scale)``, ``("const", value)`` or ``("log_linspace", lo,
  hi)``;
* ``layers(model) -> [(group, fn)]``: the reference forward between the
  embedding and the head, in order; ``fn(w, x, model, r)`` maps the
  residual stream ``x`` (b, S, d) with ``w`` the group's leaves without
  their ``<group>.`` prefix and ``r`` the rounding of
  :func:`portbench.reference.lm.rounding`;
* ``model_flops(model, seqs, seq_len, mode) -> float``: the frozen count of
  model FLOPs of a forward (``"forward"``) or a training step
  (``"train"``).
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def family(model: dict):
    """The module ``families/<model["family"]>.py``."""
    name = model["family"]
    if name.startswith("_") or not (HERE / f"{name}.py").is_file():
        raise KeyError(f"no family file portbench/families/{name}.py")
    return importlib.import_module(f"portbench.families.{name}")
