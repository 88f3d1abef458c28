"""Whole runs on the CPU at the port's smoke widths: the program against
the plain reference, every fault each cell can have coming out not
correct, and the control (the reference in float8 in the program's
place) failing the cells' limits."""

import numpy as np
import pytest
import torch

from portbench import drivers, harness, smoke
from portbench.drivers import _scoring
from portbench.reference import lm as ref

CELLS = [c["name"] for c in harness.benchmark()["workloads"]]


def _kind(cell):
    return drivers.load(harness.pieces(harness.cell_of(
        harness.benchmark(), cell))[1]["kind"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_agrees_with_the_reference(cell):
    out = smoke.run(cell)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert c["value"] <= max(1e-5, c["limit"]), name
    bench = harness.benchmark()
    want = {m["name"] for m in harness.end_to_end_of(bench, cell)}
    assert set(out["metrics"]) == want
    assert out["metrics"]["setup_s"]["value"] > 0


PLANTED = [(c, f) for c in CELLS for f in _kind(c).FAULTS]


@pytest.mark.parametrize("cell,fault", PLANTED)
def test_a_planted_fault_is_not_correct(cell, fault):
    with _kind(cell).FAULTS[fault]():
        out = smoke.run(cell)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    """The reference in float8, put in the program's place, compared as the
    run compares the program."""
    bench = harness.benchmark()
    config, traffic, limits = smoke.pieces(bench, cell)
    cpu = torch.device("cpu")
    seed = 2**35 + 11
    if traffic["kind"] == "train_stream":
        kind = drivers.load("train_stream")
        want = kind.follow(config, traffic, seed, cpu, torch)
        got = kind.follow(config, traffic, seed, cpu, torch, precision="fp8")
        numbers = kind.against(got["losses"], got["first_grad"],
                               got["change"], want)
    else:
        g = torch.Generator().manual_seed(seed % 2**31)
        toks = torch.randint(0, config["model"]["vocab"], (8, 32),
                             generator=g)
        a = ref.score_records(config["model"], seed, toks)
        b = ref.score_records(config["model"], seed, toks, precision="fp8")
        numbers = {"score_gap_nats": float((a - b).abs().max())}
    failing = [n for n, v in numbers.items()
               if n in limits and v > limits[n]["limit"]]
    assert failing, numbers


def test_flat_records_are_one_token_repeated():
    rows = np.array([[3, 3, 3], [0, 0, 0], [1, 2, 1], [5, 5, 4]])
    assert _scoring.flat(rows).tolist() == [True, True, False, False]


@pytest.mark.parametrize("precision,bits", [("bf16", 8), ("fp8", 3)])
def test_the_reference_rounds_to_the_precision_it_is_asked(precision, bits):
    x = torch.linspace(1.0, 2.0, 1001)
    err = (ref.rounding(precision)(x) - x).abs().max()
    assert 0 < err <= 2.0 ** -bits
    assert torch.equal(ref.rounding("float32")(x), x)
