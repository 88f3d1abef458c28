"""The mesh planner's second half for the MoE decoder on four ``gloo``
ranks ((2, 2)): Arctic's smoke config with its experts over ``model``,
and over ``data`` (``moe_ep=data``, the tokens crossing by all-to-all),
each sharded train step against the JAX package's single-device step and
each prefill + decode against the unsharded port; 8-bit moments on
expert-split rows (that last run's step).  The runs, bars and harness are
``tests/test_torch_mesh_families.py``'s (its child runs the ``arctic``
case); this file holds the MoE's share so that pytest-xdist's workers
share the runs.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_mesh_families as fam  # noqa: E402
from test_torch_mesh_families import jax_step, ranks, reference  # noqa: E402,F401


@pytest.mark.parametrize(**fam.runs_of("arctic"))
def test_sharded_train_step_matches_reference(ranks, jax_step, run):
    fam.check_train(ranks, jax_step, run)


@pytest.mark.parametrize(**fam.runs_of("arctic"))
def test_sharded_prefill_and_decode_match_unsharded(ranks, run):
    fam.check_serve(ranks, run)


def test_bits8_moments_on_expert_split_rows_match_unsharded(ranks):
    fam.check_bits8(ranks)
