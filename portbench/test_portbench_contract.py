"""BENCHMARK.json and the files it names, held to the benchmark's rules:
names and units of the allowed characters, every piece found by name,
every cell reporting set-up, another end-to-end metric and a per-layer
metric, per-layer metrics only in cells that report what they move."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head|expand|d_model|d_ff|d_inner|experts_per")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_fields(bench, section):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if section == "end_to_end" else {"layer", "moves"}
    sources = ({"host_clock", "device_trace"} if section == "end_to_end"
               else {"device_trace", "program_span", "program_counter",
                     "host_clock"})
    for m in bench[section]:
        assert set(m) <= allowed, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in sources
        if section == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_setup_bound_and_presence(bench):
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


def test_configs_are_files_under_paths(bench):
    used = {c["config"] for c in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg["model"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
        assert 1 <= len(c["why"]) <= 200


def test_every_cell_finds_its_pieces_by_name(bench):
    from portbench import drivers, harness
    from portbench.families import family
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for c in bench["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["config"] in configs and c["chips"] in (1, 4)
        assert NAME.match(c["traffic"]) and len(c["why"]) <= 200
        assert (c["config"], c["traffic"]) not in pairs
        pairs.add((c["config"], c["traffic"]))
        with open(HERE / "traffic" / f"{c['traffic']}.json") as f:
            assert json.load(f)["kind"] in drivers.kinds()
        with open(HERE / "limits" / f"{c['name']}.json") as f:
            assert json.load(f)
        with open(HERE / "configs" / f"{c['config']}.json") as f:
            assert family(json.load(f)["model"]).layers
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]


def test_each_cell_reports_setup_another_metric_and_a_layer(bench):
    from portbench.harness import end_to_end_of, per_layer_of
    for c in bench["workloads"]:
        e2e = {m["name"] for m in end_to_end_of(bench, c["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = per_layer_of(bench, c["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e, (c["name"], m["name"])


def test_at_most_a_quarter_of_cells_on_four_chips(bench):
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
