"""Small sizes for driving whole runs on the CPU in the tests: each
configuration and traffic file carries its own under ``smoke`` (a
configuration's ``smoke.model`` sizes over its ``model``, a mix's
``smoke`` over its parameters).  The cells' own limits hold unchanged."""

from __future__ import annotations

import copy
import time


def pieces(bench: dict, cell: str) -> tuple[dict, dict, dict]:
    """(configuration, traffic, limits) of ``cell`` at the small sizes."""
    from portbench import harness
    config, traffic, limits = harness.pieces(harness.cell_of(bench, cell))
    config = copy.deepcopy(config)
    config["model"].update(config["smoke"]["model"])
    traffic = {**traffic, **traffic["smoke"]}
    return config, traffic, limits


def run(cell: str, seed: int = 2**33 + 5, seconds: float = 1.0) -> dict:
    """One whole run of ``cell`` on the CPU at the small sizes."""
    import torch

    from portbench import harness
    bench = harness.benchmark()
    config, traffic, limits = pieces(bench, cell)
    return harness.run_cell(bench, cell, seed, seconds, False,
                            torch.device("cpu"), time.perf_counter(),
                            config, traffic, limits)
