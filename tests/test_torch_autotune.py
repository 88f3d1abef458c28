"""The port's block policy (``repro_torch.kernels.autotune``, ROADMAP K3):
the decision table's key and JSON form against the reference's
(``repro.kernels.autotune``), the race and its counters, the configs'
shared memory, the instantiation lists against ``csrc/edge_latency.cu``,
``block_geometry``, and the dispatch's pinned / chosen / refused configs.
Everything here is host work; the configs' launches and their bitwise
equality are held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s block_policy phase)."""

import json
import re
from pathlib import Path

import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch import obs
from repro_torch.kernels import autotune, dispatch, ref
from repro_torch.kernels import edge_latency as kernels
from repro_torch.kernels.autotune import (DEFAULT_CONFIG, KernelConfig,
                                          ShapeKey)

CU = Path(kernels.__file__).with_name("csrc") / "edge_latency.cu"
# serve_dense's K1 shape, the controller's and serve_structured's K2 shape
SHAPES = [("dense", 1024, 21, 4096, None, 1), ("dense", 65, 2, 4096, None, 1),
          ("structured", 256, 21, 131_072, 8, 1),
          ("dense", 4, 33, 300, None, 4), ("structured", 3, 130, 129, 1, 3)]


@pytest.fixture(autouse=True)
def _fresh_table():
    autotune.clear_table()
    yield
    autotune.clear_table()


def _source_constants() -> dict:
    src = CU.read_text()
    out = {k: int(re.search(rf"constexpr int[^;]*\b{k} = (\d+)", src)
                  .group(1))
           for k in ("K1_STAGES", "K1_GROUP", "S_ROWS", "S_UNROLL")}
    for name in ("K1_CONFIGS", "K2_CONFIGS"):
        body = re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S).group(1)
        out[name] = tuple((int(a), int(b)) for a, b in
                          re.findall(r"X\((\d+), (\d+)\)", body))
    return out


# -- the table's key and JSON form --------------------------------------------

def test_b_bucket_matches_the_reference():
    for B in range(1, 70_001):
        ours = ShapeKey.of("cuda", "dense", B, 21, 4096, None).b_bucket
        assert ours == ref_autotune.ShapeKey.of("tpu", "dense", B, 21, 4096,
                                                None).b_bucket, B


def test_table_round_trips_through_json(tmp_path):
    for kind, B, E, V, R, cb in SHAPES:
        autotune.get_config(kind, B, E, V, R, com_batch=cb, backend="cuda")
    rows = autotune.table_rows()
    assert len(rows) == len(SHAPES)
    ref_keys = {"backend", "kind", "V", "E", "R", "b_bucket", "source"}
    for row in rows:
        assert set(row) == ref_keys | {"stages", "group", "rows", "unroll"}
    path = tmp_path / "table.json"
    autotune.save_table(path)
    assert json.loads(path.read_text())["version"] == 1
    autotune.clear_table()
    assert autotune.load_table(path) == len(SHAPES)
    assert autotune.table_rows() == rows


def test_load_table_keeps_existing_entries_and_checks_the_version(tmp_path):
    """Existing entries win over a file's, an unknown version raises — as
    in the reference — and a config with no instantiation raises."""
    mine = autotune.get_config("dense", 1024, 21, 4096, backend="cuda")
    row = {"backend": "cuda", "kind": "dense", "V": 4096, "E": 21, "R": None,
           "b_bucket": 1024, "stages": 2, "group": 8, "rows": 8, "unroll": 4,
           "source": "empirical"}
    other = dict(row, V=2048)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": 1, "entries": [row, other]}))
    assert autotune.load_table(path) == 1
    assert autotune.get_config("dense", 1024, 21, 4096,
                               backend="cuda") == mine
    assert autotune.get_config("dense", 1000, 21, 2048,
                               backend="cuda").stages == 2
    for mod in (autotune, ref_autotune):
        path.write_text(json.dumps({"version": 2, "entries": []}))
        with pytest.raises(ValueError, match="version"):
            mod.load_table(path)
    autotune.clear_table()
    path.write_text(json.dumps({"version": 1,
                                "entries": [dict(row, stages=5)]}))
    with pytest.raises(ValueError, match="no instantiation"):
        autotune.load_table(path)


# -- the choice ------------------------------------------------------------------

@pytest.mark.parametrize("kind,B,E,V,R,cb", SHAPES)
def test_get_config_races_exactly_the_top_three(kind, B, E, V, R, cb):
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    reg.clear()
    try:
        timed = []

        def timer(cfg):
            timed.append(cfg)
            return {0: 3.0, 1: 1.0, 2: 2.0}[len(timed) - 1]

        bucket = ShapeKey.of("cuda", kind, B, E, V, R).b_bucket
        ranked = autotune.rank(kind, bucket, E, V, R,
                               com_batch=1 if cb == 1 else bucket)
        got = autotune.get_config(kind, B, E, V, R, com_batch=cb,
                                  backend="cuda", timer=timer)
        assert timed == ranked[:autotune.EMPIRICAL_TOP_K][:len(ranked)]
        assert got == timed[1 if len(timed) > 1 else 0]
        again = autotune.get_config(kind, B, E, V, R, com_batch=cb,
                                    backend="cuda", timer=timer)
        assert again == got and len(timed) == min(3, len(ranked))
        count = {s: reg.value("kernels.autotune.decisions", kind=kind,
                              source=s, backend="cuda")
                 for s in ("empirical", "analytic", "table")}
        assert count == {"empirical": 1.0, "analytic": 0.0, "table": 1.0}
        fields = ("stages", "group") if kind == "dense" else ("rows",
                                                              "unroll")
        for f in fields:
            assert reg.value(f"kernels.autotune.{f}", kind=kind,
                             V=str(V)) == getattr(got, f)
        assert autotune.table_rows()[0]["source"] == "empirical"
    finally:
        reg.clear()
        reg.enabled = was


def test_analytic_choice_is_the_first_ranked_and_deterministic():
    for kind, B, E, V, R, cb in SHAPES:
        bucket = ShapeKey.of("cuda", kind, B, E, V, R).b_bucket
        first = autotune.rank(kind, bucket, E, V, R,
                              com_batch=1 if cb == 1 else bucket)
        assert first == autotune.rank(kind, bucket, E, V, R,
                                      com_batch=1 if cb == 1 else bucket)
        assert autotune.get_config(kind, B, E, V, R, com_batch=cb,
                                   backend="cuda") == first[0]
    assert {r["source"] for r in autotune.table_rows()} == {"analytic"}
    # backend None on a machine without a card is keyed "cpu"
    autotune.clear_table()
    autotune.get_config("dense", 8, 3, 64)
    assert autotune.table_rows()[0]["backend"] == (
        "cuda" if torch.cuda.is_available() else "cpu")


def test_predictions_are_finite_and_price_the_ring_and_the_waves(
        monkeypatch):
    """Every candidate's prediction is finite and positive; a deeper ring
    is never priced slower, and a ring too shallow for the round trip is
    priced slower (at the fitted 1 µs a two-stage ring hides it, as on the
    card; at 4 µs it would not); a wave of one CTA past the slots costs a
    wave of its own."""
    for kind, B, E, V, R, cb in SHAPES:
        for cfg in autotune.candidate_configs(kind, E, V, R, B=B,
                                              com_batch=cb):
            t = autotune.predict_seconds(kind, B, E, V, R, cfg, com_batch=cb)
            assert 0 < t < 1
    two, three = KernelConfig(stages=2), KernelConfig(stages=3)

    def t(cfg):
        return autotune.predict_seconds("dense", 65, 2, 4096, None, cfg)

    assert t(two) >= t(three) >= t(DEFAULT_CONFIG)
    monkeypatch.setattr(autotune, "LOAD_LATENCY_S", 4e-6)
    assert t(two) > t(three) > t(DEFAULT_CONFIG)
    assert autotune._waves(265, 264, lambda n: 1.0 + n) == 265.0 + 2.0
    assert autotune._waves(264, 264, lambda n: 1.0 + n) == 265.0
    spec = autotune.DeviceSpec()
    assert spec.occupancy("dense", DEFAULT_CONFIG, None) == 1
    assert spec.occupancy("structured", DEFAULT_CONFIG, 8) == 2


# -- shared memory and the instantiations ------------------------------------------

@pytest.mark.parametrize("R", [1, 8, 64, 1024, 7000, 14_000])
def test_every_candidate_fits_a_cta(R):
    limit = 232_448
    for kind, r in (("dense", None), ("structured", R)):
        cands = autotune.candidate_configs(kind, 21, 4096, r)
        assert cands
        for cfg in cands:
            assert autotune.smem_bytes(kind, 21, 4096, r, cfg) <= limit
    rows = {c.rows for c in autotune.candidate_configs("structured", 21,
                                                       4096, R)}
    assert rows == ({4, 8} if R <= 7200 else {4})


def test_no_candidate_fits_a_huge_r():
    with pytest.raises(ValueError, match="no structured instantiation"):
        autotune.candidate_configs("structured", 21, 4096, 20_000)


def test_default_config_is_the_sources_constants():
    c = _source_constants()
    assert (DEFAULT_CONFIG.stages, DEFAULT_CONFIG.group,
            DEFAULT_CONFIG.rows, DEFAULT_CONFIG.unroll) == (
        c["K1_STAGES"], c["K1_GROUP"], c["S_ROWS"], c["S_UNROLL"])
    assert kernels.DENSE_CONFIGS == c["K1_CONFIGS"]
    assert kernels.STRUCTURED_CONFIGS == c["K2_CONFIGS"]
    assert kernels.DENSE_CONFIGS[0] == (c["K1_STAGES"], c["K1_GROUP"])
    assert kernels.STRUCTURED_CONFIGS[0] == (c["S_ROWS"], c["S_UNROLL"])
    assert len(kernels.DENSE_CONFIGS) <= 8
    assert len(kernels.STRUCTURED_CONFIGS) <= 8


def test_block_geometry_lays_out_the_launch():
    g = kernels.block_geometry("dense", 21, 4096, None, B=1024)
    assert (g.n_batch, g.rows, g.n_rt, g.n_ut, g.nk) == (1, 21504, 168, 32,
                                                         128)
    assert g.tiles == 168 * 32 and g.smem == 4 * 3 * 16384 + 1024
    g = kernels.block_geometry("dense", 33, 300, None, KernelConfig(
        stages=3, group=16), B=4, com_batch=4)
    assert (g.n_batch, g.rows, g.n_rt, g.n_ut, g.group) == (4, 33, 1, 3, 1)
    g = kernels.block_geometry("structured", 21, 131_072, 8,
                               KernelConfig(rows=4, unroll=8), B=256)
    assert (g.n_batch, g.rows, g.tiles, g.unroll) == (1, 5376, 1344, 8)
    assert g.smem == 4 * 4 * 8 + 4 * 8 * 4
    for bad in (dict(kind="sparse"), dict(E=0), dict(com_batch=2)):
        args = dict(kind="dense", E=3, V=8, R=None, B=4, com_batch=1) | bad
        with pytest.raises(ValueError):
            kernels.block_geometry(**args)
    with pytest.raises(ValueError, match="no instantiation"):
        kernels.block_geometry("dense", 3, 8, None, KernelConfig(stages=5))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.block_geometry("structured", 3, 8, 8000,
                               KernelConfig(rows=8))


# -- the dispatch --------------------------------------------------------------

def _recording(monkeypatch):
    seen = []

    def dense(x_i, x_j, com, config=None):
        seen.append(("dense", config))
        return ref.edge_latency_dense_plain(x_i, x_j, com)

    def structured(x_i, x_j, mass, a, corr, config=None):
        seen.append(("structured", config))
        return ref.edge_latency_structured_plain(x_i, x_j, mass, a, corr)

    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    monkeypatch.setattr(kernels, "edge_latency_dense", dense)
    monkeypatch.setattr(kernels, "edge_latency_structured", structured)
    return seen


def _operands(B=3, E=4, V=40, R=8):
    g = torch.Generator().manual_seed(0)
    x = torch.rand((B, E, V), generator=g)
    return (x, x.flip(-1), torch.rand((1, V, V), generator=g),
            torch.rand((B, E, R), generator=g),
            torch.rand((1, R, V), generator=g),
            torch.rand((1, 1, V), generator=g))


def test_dispatch_hands_the_policy_or_a_pinned_config_through(monkeypatch):
    seen = _recording(monkeypatch)
    x, xj, com, mass, a, corr = _operands()
    dispatch.edge_latency(x, xj, com)
    dispatch.edge_latency_structured(x, xj, mass, a, corr)
    assert seen == [
        ("dense", autotune.get_config("dense", 3, 4, 40, backend="cuda")),
        ("structured", autotune.get_config("structured", 3, 4, 40, 8,
                                           backend="cuda"))]
    pinned = KernelConfig(stages=3, group=16, rows=4, unroll=8)
    dispatch.edge_latency(x, xj, com, config=pinned)
    dispatch.edge_latency_structured(x, xj, mass, a, corr, config=pinned)
    assert seen[2:] == [("dense", pinned), ("structured", pinned)]


@pytest.mark.parametrize("cfg,which", [
    (KernelConfig(stages=5), "dense"), (KernelConfig(group=3), "dense"),
    (KernelConfig(rows=32), "structured"),
    (KernelConfig(rows=8), "structured-large-R")])
def test_dispatch_refuses_an_infeasible_config(monkeypatch, cfg, which):
    """A config with no instantiation, or whose mass tile exceeds a CTA's
    227 KB at this R, raises before any launch — on the card route, and
    on the CPU route too; it is never replaced by the default."""
    seen = _recording(monkeypatch)
    R = 8000 if which == "structured-large-R" else 8
    x, xj, com, mass, a, corr = _operands(R=R)
    run = (lambda: dispatch.edge_latency(x, xj, com, config=cfg)) \
        if which == "dense" else \
        (lambda: dispatch.edge_latency_structured(x, xj, mass, a, corr,
                                                  config=cfg))
    with pytest.raises(ValueError):
        run()
    assert seen == []
    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "plain")
    if which != "structured-large-R":    # the plain route has no tiles
        with pytest.raises(ValueError, match="no instantiation"):
            run()


def test_plain_route_takes_no_config(monkeypatch):
    """The CPU route is unchanged: no policy is consulted, the plain
    version computes, and a pinned instantiated config changes nothing."""
    x, xj, com, mass, a, corr = _operands()
    want = ref.edge_latency_dense_plain(x, xj, com)
    assert torch.equal(dispatch.edge_latency(x, xj, com), want)
    assert torch.equal(dispatch.edge_latency(
        x, xj, com, config=KernelConfig(stages=2)), want)
    assert autotune.table_rows() == []


# -- the chip_smoke.py phase, rehearsed ------------------------------------------

def test_chip_smoke_block_policy_phase_rehearses_on_the_cpu(monkeypatch,
                                                            capsys):
    """chip_smoke.py's block_policy phase on the CPU at small shapes, K1 /
    K2 and K4a / K4b swapped for plain versions that record their config
    and report ``block_geometry``'s tiles as the launcher does, the timer
    stubbed: every candidate runs and is compared, the race takes the top
    three, and the decisions land in the table."""
    import sys
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    seen = []

    def fake(kind, plain):
        name = f"edge_latency_{kind}"

        def run(*args, config=None):
            seen.append((kind, config))
            B, E, V = args[0].shape
            R = args[2].shape[-1] if kind == "structured" else None
            g = kernels.block_geometry(kind, E, V, R, config, B=B,
                                       com_batch=args[-1].shape[0])
            kernels.last_launch[name] = {"tiles": g.tiles, "ctas": g.tiles}
            return plain(*args)
        return run

    def single(plain, R_of):
        def run(*args):
            kernels.check_single_tile(args[0].shape[-1], R_of(args))
            return plain(*args)
        return run

    monkeypatch.setattr(kernels, "edge_latency_dense",
                        fake("dense", ref.edge_latency_dense_plain))
    monkeypatch.setattr(kernels, "edge_latency_structured",
                        fake("structured", ref.edge_latency_structured_plain))
    monkeypatch.setattr(kernels, "edge_latency_dense_single_tile", single(
        ref.edge_latency_dense_single_tile_plain, lambda a: None))
    monkeypatch.setattr(kernels, "edge_latency_structured_single_tile",
                        single(ref.edge_latency_structured_single_tile_plain,
                               lambda a: a[2].shape[-1]))
    monkeypatch.setattr(kernels, "last_launch", {})
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: 1.0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(chip_smoke, "BLOCK_SHAPES", (
        ("serve_dense", "dense", 40, 5, 70, None),
        ("controller", "dense", 5, 2, 70, None),
        ("serve_structured", "structured", 6, 5, 300, 8)))
    out = chip_smoke.block_policy_phase(torch, torch.device("cpu"),
                                        card="CPU rehearsal")
    assert set(out["summary"]) == {"serve_dense", "controller",
                                   "serve_structured"}
    for label, row in out["summary"].items():
        assert len(row["raced"]) == min(3, len(row["candidates"]))
        assert row["pick"] == row["candidates"][0]["config"]
    assert len(out["table"]) == 3
    assert all(r["source"] == "empirical" for r in out["table"])
    pairs = {(k, (c.stages, c.group) if k == "dense" else (c.rows, c.unroll))
             for k, c in seen if c is not None}
    assert {p for k, p in pairs if k == "dense"} == set(kernels.DENSE_CONFIGS)
    assert {p for k, p in pairs if k == "structured"} == \
        set(kernels.STRUCTURED_CONFIGS)
    text = capsys.readouterr().out
    assert "block_policy serve_dense" in text and "decision table" in text
