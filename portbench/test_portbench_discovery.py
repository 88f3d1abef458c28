"""The harness finds a configuration, a traffic mix, a cell's limits, a
per-layer metric, a traffic kind's driver and a model family by name, so
that a later change adds them as files; and the command line refuses to
run without a card or without the port."""

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import drivers, harness, smoke

ROOT = Path(__file__).resolve().parent.parent


def _copy(tmp_path) -> Path:
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return here


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    here = _copy(tmp_path)
    with open(here / "traffic" / "score_backlog.json") as f:
        mix = json.load(f)
    mix["records_per_batch"] = 64
    with open(here / "traffic" / "score_half.json", "w") as f:
        json.dump(mix, f)
    (here / "limits" / "mamba2-1.3b.half.json").write_text(
        (here / "limits" / "mamba2-1.3b.score.json").read_text())
    (here / "metrics" / "batches.score.py").write_text(
        "def read(run):\n    return float(run.counters['batches'])\n")
    cell = {"name": "mamba2-1.3b.half", "config": "mamba2-1.3b",
            "traffic": "score_half", "chips": 1}
    config, traffic, limits = harness.pieces(cell, here)
    assert traffic["records_per_batch"] == 64
    assert config["registry"] == "mamba2_1_3b" and limits
    read = harness.reader("batches.score", here)
    run = drivers.Run("mamba2-1.3b.half", config, traffic, None,
                      {"batches": 3})
    assert read(run) == 3.0


KIND = """
class Driver:
    def __init__(self, run, seed, device, torch):
        self.run = run


FAULTS = {}
"""

FAMILY = """
from portbench.weights import padded_vocab


def groups(model):
    return ["embed", "head"]


def leaves(model, group):
    vp = padded_vocab(model)
    if group == "embed":
        return [("embed", (vp, 4), ("normal", 1.0))]
    return [("final_norm", (4,), ("log_linspace", 1.0, 2.0)),
            ("head", (4, vp), ("const", 1.0))]


def layers(model):
    return []


def model_flops(model, seqs, seq_len, mode):
    return 8.0 * seqs * seq_len * model["vocab"]
"""


def test_a_new_kind_and_family_are_found_by_name(tmp_path):
    here = _copy(tmp_path)
    (here / "drivers" / "replay.py").write_text(KIND)
    (here / "families" / "toy.py").write_text(FAMILY)
    code = (
        "import sys; sys.path[0] = sys.argv[1]\n"
        "from portbench import drivers, weights\n"
        "from portbench.families import family\n"
        "assert 'replay' in drivers.kinds()\n"
        "assert drivers.load('replay').Driver\n"
        "m = {'family': 'toy', 'vocab': 6, 'vocab_pad': 4}\n"
        "assert family(m).model_flops(m, 1, 2, 'forward') == 96.0\n"
        "import torch\n"
        "named = {'embed': torch.empty(8, 4), 'final_norm': torch.empty(4),"
        " 'head': torch.empty(4, 8)}\n"
        "weights.load_into(named, m, 3)\n"
        "print(float(named['final_norm'][-1]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == pytest.approx(math.log(2.0))
    with pytest.raises(KeyError):
        drivers.load("replay")          # only in the copy
    with pytest.raises(KeyError):
        drivers.load("_scoring")        # shared code, no kind


def test_a_metric_without_a_file_of_its_own_takes_its_stems_reader(
        tmp_path):
    here = _copy(tmp_path)
    (here / "metrics" / "rate.py").write_text(
        "def read(run):\n    return 1.0\n")
    (here / "metrics" / "rate.train.py").write_text(
        "def read(run):\n    return 2.0\n")
    assert harness.reader("rate.score", here)(None) == 1.0
    assert harness.reader("rate.train", here)(None) == 2.0
    assert harness.reader("rate", here)(None) == 1.0
    with pytest.raises(FileNotFoundError):
        harness.reader("none.train", here)


def test_a_per_layer_metric_reads_a_small_run():
    bench = harness.benchmark()
    config, traffic, _ = smoke.pieces(bench, "mamba2-1.3b.score")
    from portbench import counts
    from portbench.families import ssm
    flops = ssm.model_flops(config["model"], 100, 32, "forward")
    run = drivers.Run("mamba2-1.3b.score", config, traffic, None,
                      {"model_flops": flops}, window=(0.0, 2.0))
    mfu = harness.reader("mfu.score")(run)
    assert mfu == pytest.approx(100 * flops / (counts.PEAK_BF16_TC * 2.0))
    assert harness.reader("k6_roofline.score")(run) is None   # no trace


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-1.3b.score", "--seed", "5", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")


def test_the_command_refuses_without_a_card(no_card):
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_command_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", ["mamba2-1.3b.score", "mamba2-1.3b.train"])
def test_every_reader_of_a_cell_reads_a_synthetic_trace(cell):
    from portbench import devtrace
    bench = harness.benchmark()
    config, traffic, _ = harness.pieces(harness.cell_of(bench, cell))
    spans = devtrace.Spans()
    for i in range(4):
        spans.add("engine.run_batch", 1.0 * i, 1.0 * i + 0.9)
        spans.add("op.lm_score", 1.0 * i + 0.1, 1.0 * i + 0.8)
        spans.add("data.next", 1.0 * i, 1.0 * i + 0.001)
    ops = [("ssd_scan_output_kernel", 0.2, 0.3),
           ("ssd_bwd_tc_chunk_kernel", 0.4, 0.6),
           ("sm90_xmma_gemm_bf16", 0.6, 3.5)]
    run = drivers.Run(cell, config, traffic, spans,
                      {"scored_records": 512, "lm_shards": [11] * 12,
                       "steps": 4, "model_flops": 1e15}, window=(0.0, 4.0),
                      trace=devtrace.DeviceTrace(ops, 0.0, 4.0))
    for m in harness.per_layer_of(bench, cell):
        v = harness.reader(m["name"])(run)
        assert isinstance(v, float) and v >= 0, m["name"]
        if m["unit"] == "%":
            assert v <= 100 or "roofline" in m["name"], m["name"]
