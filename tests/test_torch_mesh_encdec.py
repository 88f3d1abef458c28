"""The mesh planner's second half for the Llama-Vision VLM and Whisper on
four ``gloo`` ranks ((2, 2)): each sharded train step against the JAX
package's single-device step (the VLM's cross gates opened) and each
prefill + decode, with the image or frame inputs, against the unsharded
port.  The runs, bars and harness are
``tests/test_torch_mesh_families.py``'s; this file holds their share so
that pytest-xdist's workers share the runs.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_mesh_families as fam  # noqa: E402
from test_torch_mesh_families import jax_step, ranks, reference  # noqa: E402,F401


@pytest.mark.parametrize(**fam.runs_of("vlm", "whisper"))
def test_sharded_train_step_matches_reference(ranks, jax_step, run):
    fam.check_train(ranks, jax_step, run)


@pytest.mark.parametrize(**fam.runs_of("vlm", "whisper"))
def test_sharded_prefill_and_decode_match_unsharded(ranks, run):
    fam.check_serve(ranks, run)
