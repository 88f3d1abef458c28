"""The dry run's miniature train cell of each family of the mesh planner's
second half on 8 fake ranks ((2, 4), torch's ``fake`` backend, in a child
process): Mamba2, Zamba2, Arctic (the baseline with 6 query heads, which
the model axis does not divide, and ``moe_ep=data``, whose tokens cross
by all-to-all), the VLM and Whisper.
Per cell: the per-device parameter and moment bytes from the specs, the
FSDP collectives, positive terms and ``choose_layout``'s pick with the
MoE branch (``tests/test_torch_mesh_families.py`` holds the cells and the
checks).
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_mesh_families as fam  # noqa: E402


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    return fam.fake_cells(tmp_path_factory)


@pytest.mark.parametrize("arch, variant", fam.FAKE_CELLS,
                         ids=[f"{a}-{v or 'baseline'}"
                              for a, v in fam.FAKE_CELLS])
def test_dry_run_miniature_cell_of_each_family(fake, arch, variant):
    fam.check_fake_cell(fake, arch, variant)
