"""The port's ground rules, checked on the CPU: package hygiene (no jax, no
``repro`` imports), the device policy (``None`` means the card and raises
without CUDA; a CPU tensor never reaches a CUDA kernel wrapper), the kernel
build's contract, ``chip_smoke.py``'s refusal to run without a card, and
the small copied/ported helpers (convert, sanitize, obs, roofline)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert, obs  # noqa: E402
from repro_torch.analysis import AnalysisError, sanitize  # noqa: E402
from repro_torch.core.graph import random_dag  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels import edge_latency as kernels  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402
from repro_torch.serve import DispatchPricer, WhatIfService  # noqa: E402
from repro_torch.sim import BatchedEvaluator  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _graph():
    return random_dag(4, 0.6, np.random.default_rng(0))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: dispatch.resolve_device(None),
                 lambda: dispatch.resolve_device("cuda"),
                 lambda: BatchedEvaluator(_graph()),
                 lambda: BatchedEvaluator.shared(_graph()),
                 lambda: WhatIfService(_graph())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_device("meta")


def test_cpu_tensors_never_reach_the_kernel_wrappers(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    monkeypatch.setattr(kernels, "edge_latency_dense", refuse)
    monkeypatch.setattr(kernels, "edge_latency_structured", refuse)
    from repro_torch.core.devices import RegionFleetFamily
    rng = np.random.default_rng(1)
    g = _graph()
    V = 5
    x = rng.random((3, g.n_ops, V)).astype(np.float32)
    ev = BatchedEvaluator(g, device="cpu")
    coms = rng.random((2, V, V)).astype(np.float32)
    fam = RegionFleetFamily(region=rng.integers(0, 2, V),
                            inter=rng.random((2, 2, 2)),
                            degrade=np.ones((2, V)))
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    try:
        before = reg.value("kernels.dispatch.plans", kind="dense",
                           impl="plain")
        assert ev.score_grid(x, coms).shape == (2, 3)
        assert ev.score_grid(x, fam).shape == (2, 3)
        assert reg.value("kernels.dispatch.plans", kind="dense",
                         impl="plain") == before + 2
        assert reg.value("kernels.dispatch.plans", kind="dense",
                         impl="cuda") == 0
    finally:
        reg.enabled = was


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_latency_dense(x, x, torch.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.edge_latency_structured(x, x, torch.zeros((2, 3, 2)),
                                        torch.zeros((1, 2, 4)),
                                        torch.zeros((1, 1, 4)))
    with pytest.raises(ValueError, match="1 or 2"):
        kernels.edge_latency_dense(x, x, torch.zeros((3, 4, 4)))
    assert kernels.launches == {k: 0 for k in kernels.KERNELS}


def test_dispatch_refuses_mixed_and_unknown_devices():
    cpu = torch.zeros((1, 2, 3))
    meta = torch.empty((1, 3, 3), device="meta")
    with pytest.raises(ValueError, match="span devices"):
        dispatch.edge_latency(cpu, cpu, meta)
    with pytest.raises(ValueError, match="no edge-latency route"):
        dispatch.plan_edge_kernel("dense", meta)


def test_build_targets_sm90a_and_keys_libraries_by_source(tmp_path,
                                                          monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build._lib_path(src)
    src.write_text("// two\n")
    assert build._lib_path(src) != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "build").exists()


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _chip_smoke().main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    """Run as a script from a directory that holds chip_smoke.py and
    nothing else of the repository: non-zero exit, no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_needs_the_port_beside_it(tmp_path, monkeypatch, capsys):
    """With a card but without src/repro_torch next to it, main() fails
    before importing anything of the port."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_convert_round_trips_graph_family_and_pack():
    g = random_dag(5, 0.5, np.random.default_rng(2))
    ops = g.operators
    back = convert.graph_from_arrays(
        [o.name for o in ops], [o.selectivity for o in ops],
        [o.out_bytes for o in ops], [o.work for o in ops],
        [o.dq_eligible for o in ops], np.asarray(g.edges))
    assert back.operators == g.operators and back.edges == g.edges
    with pytest.raises(ValueError, match="disagree"):
        convert.graph_from_arrays(["a"], [1.0, 2.0], [1.0], [0.0], [False],
                                  [])
    fam = convert.region_family_from_arrays(
        [0, 1, 1], np.ones((2, 2, 2)), np.ones((2, 3)), 0.5)
    assert (fam.n_scenarios, fam.n_devices, fam.n_regions) == (2, 3, 2)
    pack = convert.dense_pack_from_array(np.ones((2, 3, 3)))
    assert pack.dtype == np.float32
    with pytest.raises(ValueError, match=r"\(S, V, V\)"):
        convert.dense_pack_from_array(np.ones((2, 3, 4)))


def test_sanitize_accepts_tensors():
    sanitize.check_finite("ok", torch.ones(3))
    with pytest.raises(AnalysisError, match="NaN"):
        sanitize.check_finite("bad", torch.tensor([1.0, float("nan")]))
    sanitize.check_dq(torch.tensor([0.0, 1.0]))
    with pytest.raises(AnalysisError, match="dq_fraction"):
        sanitize.check_dq(torch.tensor([0.5, 1.5]))
    with sanitize.sanitized():
        ev = BatchedEvaluator(_graph(), device="cpu")
        with pytest.raises(AnalysisError):
            ev.score_grid(np.ones((1, 4, 3), np.float32),
                          np.ones((2, 3, 3), np.float32), dq=[0.5, 2.0])
    assert not sanitize.enabled()


def test_span_sync_on_a_cpu_tensor_records_a_synced_span():
    obs.clear_trace()
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    try:
        with obs.span("x", n=1) as sp:
            sp.sync(torch.ones(2))
        (ev,) = [e for e in obs.trace_events() if e["name"] == "x"]
        assert ev["args"]["synced"] and ev["args"]["compile_s"] == 0.0
        obs.validate_events(obs.trace_events())
    finally:
        reg.enabled = was
        obs.clear_trace()


def test_roofline_and_pricer_use_the_h100_rates():
    t = roofline.compute_terms(67e12, 3.35e12 / 2)
    assert t.compute_s == pytest.approx(1.0) and t.dominant == "compute"
    assert t.step_time_s == pytest.approx(1.0)
    p = DispatchPricer(n_edges=10, n_devices=4096)       # dense: FP32 bound
    B = 4 * 1024
    flops = 2.0 * B * 10 * 4096 ** 2 + B * 10 * 4096
    assert p.roofline_bound_s(4, 1024) == pytest.approx(flops / 67e12)
    s = DispatchPricer(n_edges=10, n_devices=131072, n_regions=8)
    assert roofline.compute_terms(1.0, 1.0).dominant == "memory"
    assert s.roofline_bound_s(4, 256) > 0.0
