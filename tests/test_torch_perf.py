"""The port's telemetry and calibration substrate (ROADMAP A10b) against the
JAX package on the CPU: ``perf.counts`` against ``repro.perf.hlo``,
``perf.roofline``'s step terms against ``repro.perf.roofline``,
``obs.perfbridge`` against ``repro.obs.perfbridge``, the build hooks
(``obs.kernelhooks``) against ``repro.obs.jaxhooks``' contract, and the
calibration pieces (``fleet_from_gpu_mesh``, ``calibrate_from_profile``,
``stage_graph_for_lm``) against ``repro.core``'s; then the rehearsals of
``chip_smoke.py``'s perf-record, hook-overhead and build-span phases.

Bars: matmul FLOP counts within 1 % of ``analyze_module`` (the
reference's own tolerance).  Whole smoke forwards: the reference's module
also counts the one-hot embedding matmul (2·B·S·V_pad·d; the port selects
rows) and each reduction's operand elements (FlopCounterMode counts
matmul-class ops only), so its dots less the one-hot matmul equal the
port's count exactly, and its total is the port's plus the one-hot matmul
within 1 % (the reductions: 0.3–0.4 % at the smoke sizes).  Fleets, stage
graphs, ring-model wire bytes and roofline rows (with the reference's
constants patched in) equal, bitwise where the reference computes the
same expression.
"""

import contextlib
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import calibration as jax_calibration  # noqa: E402
from repro.core.devices import fleet_from_tpu_mesh  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.obs import perfbridge as jax_perfbridge  # noqa: E402
from repro.perf import hlo  # noqa: E402
from repro.perf import roofline as jax_roofline  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import calibration  # noqa: E402
from repro_torch.core.devices import (NET_GBPS, NVLINK_GBPS,  # noqa: E402
                                      fleet_from_gpu_mesh)
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels import edge_latency as el  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import bench, kernelhooks, perfbridge, spans  # noqa
from repro_torch.perf import counts, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _hlo(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax.jit(fn).lower(*args).compile().as_text()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- counts -----

def test_matmul_chain_flops_match_analyze_module():
    """``test_perf_hlo.py``'s unrolled chain: 8 × (128³ products + tanh)."""
    def jfn(x, w):
        for i in range(8):
            x = jnp.tanh(x @ w[i])
        return x.sum()

    def tfn(x, w):
        for i in range(8):
            x = torch.tanh(x @ w[i])
        return x.sum()

    want = hlo.analyze_module(_hlo(jfn, (128, 128), (8, 128, 128))).flops
    for dev in ("cpu", "meta"):
        x = torch.zeros((128, 128), device=dev)
        w = torch.zeros((8, 128, 128), device=dev)
        got = counts.analyze_call(tfn, (x, w)).flops
        assert got == 8 * 2 * 128 ** 3
        assert got == pytest.approx(want, rel=0.01)


def test_batched_einsum_flops_match_analyze_module():
    """``test_perf_hlo.py:32``'s batched einsum."""
    want = hlo.analyze_module(_hlo(
        lambda a, b: jnp.einsum("bij,bjk->bik", a, b).sum(),
        (4, 32, 64), (4, 64, 16))).flops
    got = counts.analyze_call(
        lambda a, b: torch.einsum("bij,bjk->bik", a, b).sum(),
        (_meta(4, 32, 64), _meta(4, 64, 16))).flops
    assert got == 2 * 4 * 32 * 64 * 16
    assert got == pytest.approx(want, rel=0.01)


def _dot_flops(text: str) -> float:
    """The reference module's dot FLOPs alone, trip-count weighted."""
    comps = hlo._parse_computations(text)
    mult, _ = hlo._exec_counts(comps)
    return sum(mult.get(name, 0.0) * hlo._instr_flops(ins, comp)
               for name, comp in comps.items() for ins in comp.instrs
               if ins.op == "dot")


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_1_3b", "zamba2_1_2b"])
def test_smoke_forward_flops_match_analyze_module(arch):
    jcfg = jax_smoke(arch)
    jmodel = jax_build(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    B, S = 2, 16
    text = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})[0]).lower(
        params, jnp.zeros((B, S), jnp.int32)).compile().as_text()
    ref_total = hlo.analyze_module(text).flops
    onehot = 2.0 * B * S * jcfg.vocab_padded * jcfg.d_model
    cfg = get_smoke_config(arch)
    got = {}
    for data in (True, False):
        with (contextlib.nullcontext() if data else counts.without_data()):
            model = build_model(cfg, device="cpu")
            if data:
                model.init_params(torch.Generator().manual_seed(0))
            with torch.inference_mode():
                got[data] = counts.analyze_call(model, ({"tokens": torch.zeros(
                    (B, S), dtype=torch.int32)},))
    got = {"cpu": got[True], "fake": got[False]}
    assert got["fake"].flops == got["cpu"].flops
    assert got["fake"].kernels.keys() == got["cpu"].kernels.keys()
    assert got["cpu"].flops == _dot_flops(text) - onehot
    assert got["cpu"].flops + onehot == pytest.approx(ref_total, rel=0.01)
    # the plain versions' work, split by kernel scope
    kernels = got["cpu"].kernels
    if cfg.family != "dense":
        assert kernels["ssd_scan"]["calls"] == cfg.n_layers
        assert kernels["rmsnorm"]["flops"] == 0.0
        assert kernels["rmsnorm"]["bytes"] > 0


def test_bytes_at_op_boundaries():
    """An op reads its inputs and writes its output; views and empty
    allocations move nothing; a broadcast operand counts its distinct
    elements once; a lookup moves twice its output plus its indices."""
    x, y = torch.zeros((8, 16)), torch.zeros((16,))
    st = counts.analyze_call(lambda: (x + y).t().unsqueeze(0)[:, 1:])
    assert st.hbm_bytes == 4 * (8 * 16 + 16 + 8 * 16)
    st = counts.analyze_call(lambda: torch.empty((1000, 1000)))
    assert st.hbm_bytes == 0
    table, idx = torch.zeros((100, 32)), torch.tensor([3, 5, 7])
    st = counts.analyze_call(torch.nn.functional.embedding, (idx, table))
    assert st.hbm_bytes == 2 * 3 * 32 * 4 + 3 * 8


def test_ring_model_matches_the_reference():
    """``test_perf_hlo.py:58``'s all-reduce, and every collective kind
    against ``repro.perf.hlo._collective_wire`` on one HLO line each."""
    assert counts.ring_wire_bytes("all-reduce", 4096, 4) == \
        pytest.approx(2 * 4096 * 0.75)
    stats = hlo.parse_collectives("""
HloModule test, is_scheduled=true

ENTRY %main (x: f32[1024]) -> f32[1024] {
  %x = f32[1024]{0} parameter(0)
  ROOT %ar = f32[1024]{0} all-reduce(%x), channel_id=1, replica_groups={{0,1,2,3}}, to_apply=%add
}
""")
    assert counts.ring_wire_bytes("all-reduce", 4096, 4) == \
        stats.wire_bytes["all-reduce"]
    for op in hlo.COLLECTIVE_OPS:
        for n in (1, 2, 4, 16):
            groups = "{" + ",".join(map(str, range(n))) + "}"
            line = (f"  %c = f32[256,8]{{1,0}} {op}(%x), channel_id=1, "
                    f"replica_groups={{{groups}}}")
            ins = hlo._Instr("c", "f32[256,8]{1,0}", op, line)
            base, wire, b = hlo._collective_wire(ins, None)
            assert base == op and b == 256 * 8 * 4
            assert counts.ring_wire_bytes(op, b, n) == wire, (op, n)
    with pytest.raises(ValueError, match="unknown collective"):
        counts.ring_wire_bytes("broadcast", 8, 2)


@pytest.fixture
def fake_group():
    """A 16-rank process group in this one process (torch's ``fake``
    backend: collectives return without communicating)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_functional_collectives_are_counted(fake_group):
    import torch.distributed._functional_collectives as fc

    x = torch.zeros((1024, 1024), dtype=torch.bfloat16)

    def step():
        y = fc.wait_tensor(fc.all_reduce(x, "sum", fake_group))
        z = fc.wait_tensor(fc.all_gather_tensor(x[:64], 0, fake_group))
        return y, z

    st = counts.analyze_call(step)
    c = st.collectives
    assert c.counts == {"all-reduce": 1, "all-gather": 1}
    mib2 = 1024 * 1024 * 2
    assert c.wire_bytes["all-reduce"] == 2 * mib2 * 15 / 16
    assert c.result_bytes["all-gather"] == 16 * 64 * 1024 * 2
    assert c.wire_bytes["all-gather"] == 16 * 64 * 1024 * 2 * 15 / 16
    assert c.summary()["total_wire_bytes"] == c.total_wire_bytes


# --------------------------------------------------------- calibration ----

def test_calibrate_from_profile_equals_calibrate_from_hlo(fake_group):
    """``test_calibration.py:12-29``'s 2 MiB bf16 all-reduce over 16: the
    port's record of it (counted from the functional op) calibrates as the
    reference's HLO does, at the same link speed."""
    import torch.distributed._functional_collectives as fc

    x = torch.zeros((1024, 1024), dtype=torch.bfloat16)
    st = counts.analyze_call(
        lambda: fc.wait_tensor(fc.all_reduce(x, "sum", fake_group)))
    want = jax_calibration.calibrate_from_hlo(
        ROOT.joinpath("tests", "test_calibration.py").read_text().split(
            'HLO = """')[1].split('"""')[0], flops_per_device=1e12,
        n_pods=1, chips_per_pod=256)
    got = calibration.calibrate_from_profile(st, flops_per_device=1e12,
                                             n_nodes=32, gpus_per_node=8)
    assert got.bytes_per_step == want.bytes_per_step
    assert got.flops_per_step == want.flops_per_step
    for gbps in (50.0, NVLINK_GBPS):
        assert got.step_comm_seconds(gbps) == want.step_comm_seconds(gbps)
    assert got.step_comm_seconds() == want.bytes_per_step / 450e9
    assert got.fleet.n_devices == want.fleet.n_devices == 256
    assert got.collectives.counts == dict(want.collectives.counts)


@pytest.mark.parametrize("n,per,fast,slow,unit", [
    (1, 8, 450.0, 50.0, 1e9), (2, 4, 50, 5, 1e9), (3, 8, 450.0, 50.0, 1.0),
    (4, 2, 900.0, 12.5, 4096.0)])
def test_gpu_fleet_equals_the_tpu_fleet_at_equal_links(n, per, fast, slow,
                                                       unit):
    got = fleet_from_gpu_mesh(n, per, nvlink_gbps=fast, net_gbps=slow,
                              unit_bytes=unit)
    want = fleet_from_tpu_mesh(n, per, ici_gbps=fast, dci_gbps=slow,
                               unit_bytes=unit)
    assert np.array_equal(got.com_matrix(), want.com_matrix())
    assert np.array_equal(got.region, want.region)
    assert np.array_equal(got.inter, want.inter)


def test_gpu_fleet_prices_nvlink_within_and_the_network_between_nodes():
    com = fleet_from_gpu_mesh(n_nodes=2, gpus_per_node=4).com_matrix()
    assert com[0, 1] == pytest.approx(1 / NVLINK_GBPS)
    assert com[0, 5] == pytest.approx(1 / NET_GBPS)
    assert com[0, 0] == 0.0
    assert (NVLINK_GBPS, NET_GBPS) == (450.0, 50.0)


@pytest.mark.parametrize("kw", [
    dict(n_layers=4, d_model=64, d_ff=256, vocab=1000, seq=128, batch=2),
    dict(n_layers=3, d_model=32, d_ff=64, vocab=50, seq=8, batch=1,
         moe_experts=8, top_k=2)])
def test_stage_graph_for_lm_equals_the_reference(kw):
    got = calibration.stage_graph_for_lm(**kw)
    want = jax_calibration.stage_graph_for_lm(**kw)
    assert got.edges == want.edges
    assert [dataclasses.astuple(o) for o in got.operators] == \
        [dataclasses.astuple(o) for o in want.operators]


# ------------------------------------------------------------ roofline ----

@pytest.mark.parametrize("args", [
    (197e12, 819e9, 0.0, 4, 4 * 197e12 * 0.5, True),
    (1e12, 1e9, 500e9, 4, 1e12, True),
    (3e15, 2e12, 1e9, 8, 2e15, False),
    (0.0, 0.0, 0.0, 1, 0.0, True)])
def test_roofline_row_equals_the_reference_with_its_constants(monkeypatch,
                                                              args):
    want = jax_roofline.compute_terms(*args)
    flops, bytes_, wire, chips, model_flops, per_device = args
    if not per_device:      # the reference's totals as one card's share
        flops, bytes_, wire = flops / chips, bytes_ / chips, wire / chips
    monkeypatch.setattr(roofline, "PEAK_BF16_TC", jax_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jax_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", jax_roofline.ICI_BW)
    got = roofline.step_terms(flops, bytes_, wire, chips, model_flops)
    assert list(got.row()) == list(want.row())
    assert got.row() == want.row()
    assert (got.dominant, got.step_time_s, got.useful_flops_fraction,
            got.mfu_bound) == (want.dominant, want.step_time_s,
                               want.useful_flops_fraction, want.mfu_bound)


def test_step_terms_on_the_h100_and_kernel_terms_unchanged():
    t = roofline.step_terms(989e12, 3.35e12, 450e9, 1, 989e12 * 0.25)
    assert (t.compute_s, t.memory_s, t.collective_s) == \
        pytest.approx((1.0, 1.0, 1.0))
    assert t.mfu_bound == pytest.approx(0.25)
    assert t.useful_flops_fraction == pytest.approx(0.25)
    k = roofline.rmsnorm_terms(22528, 2048, torch.bfloat16)
    assert (k.collective_s, k.chips, k.model_flops) == (0.0, 1, 0.0)
    assert k.step_time_s == max(k.compute_s, k.memory_s)
    assert k.bound_by == "bytes" and k.dominant == "memory"


# ---------------------------------------------------- kernel reports ------

def _fake_launch(monkeypatch, mod, entries):
    """``mod``'s wrapper launches a fake kernel that does nothing on the
    CPU: no checks of the device, a library whose entries return 0."""
    lib = types.SimpleNamespace(**{e: (lambda *a: 0) for e in entries})
    monkeypatch.setattr(mod, "_check", lambda *a, **k: None)
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _NullDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(mod, "launches", dict.fromkeys(mod.launches, 0))


class _NullDevice:
    def __init__(self, dev):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_a_wrapper_reports_its_launch_once(monkeypatch):
    """K1's and K5's wrappers on a fake kernel: the counter sees the
    terms of ``perf.roofline`` once per launch (the wrappers' own
    allocations move nothing), through the dispatch route too, where the
    scope attributes the launch to the kernel once."""
    _fake_launch(monkeypatch, el, ["edge_latency_dense_launch"])
    B, E, V = 3, 5, 64
    args = (torch.zeros((B, E, V)), torch.zeros((B, E, V)),
            torch.zeros((1, V, V)))
    terms = roofline.edge_latency_dense_terms(B, E, V, 1)
    with counts.OpCounter() as c:
        el.edge_latency_dense(*args)
    st = c.stats()
    assert (st.flops, st.hbm_bytes) == (terms.flops, terms.bytes)
    assert st.kernels == {"edge_latency_dense": {
        "flops": terms.flops, "bytes": terms.bytes, "calls": 0,
        "launches": 1}}
    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    with counts.OpCounter() as c:
        dispatch.edge_latency(*args)
        dispatch.edge_latency(*args)
    st = c.stats()
    assert st.flops == 2 * terms.flops
    assert st.kernels["edge_latency_dense"] == {
        "flops": 2 * terms.flops, "bytes": 2 * terms.bytes, "calls": 2,
        "launches": 2}
    assert el.launches["edge_latency_dense"] == 3
    # K5: the causal half
    _fake_launch(monkeypatch, fa, ["flash_attention_launch"])
    q = torch.zeros((2, 64, 4, 16))
    with counts.OpCounter() as c:
        fa.flash_attention(q, q, q, causal=True)
    t = roofline.flash_attention_terms(2, 64, 4, 16, torch.float32, True)
    assert c.stats().flops == t.flops == 4 * 2 * 4 * 16 * 64 * 65 / 2
    # no counter open: nothing is reported, the launch still counts
    fa.flash_attention(q, q, q, causal=True)
    assert fa.launches["flash_attention"] == 2 and not counts.ACTIVE


def test_plain_routes_count_ops_without_reports():
    """On the CPU a route runs the plain version: its ops are counted,
    attributed to the kernel's scope, and nothing reports a launch."""
    x = torch.randn((6, 32))
    w = torch.ones(32)
    with counts.OpCounter() as c:
        dispatch.rmsnorm(x, w)
    k = c.stats().kernels["rmsnorm"]
    assert k["calls"] == 1 and k["launches"] == 0 and k["bytes"] > 0
    assert c.stats().hbm_bytes == k["bytes"]


# --------------------------------------------------------- perfbridge -----

def test_perf_record_renames_the_references_keys():
    want = jax_perfbridge.hlo_record(
        jax.jit(lambda a, b: a @ b),
        (jax.ShapeDtypeStruct((64, 32), jnp.float32),
         jax.ShapeDtypeStruct((32, 16), jnp.float32)), measured_s=1e-3)
    a, b = torch.zeros((64, 32)), torch.zeros((32, 16))
    got = perfbridge.perf_record(torch.matmul, (a, b), measured_s=1e-3)
    renamed = {"hlo_flops": "counted_flops", "hlo_bytes": "counted_bytes"}
    assert [renamed.get(k, k) for k in want] == \
        [k for k in got if k != "kernels"]
    assert got["counted_flops"] == want["hlo_flops"] == 2 * 64 * 32 * 16
    assert got["counted_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert list(got["roofline"]) == list(want["roofline"])
    t = roofline.step_terms(got["counted_flops"], got["counted_bytes"], 0.0,
                            1, got["counted_flops"])
    assert got["roofline_fraction"] == t.step_time_s / 1e-3
    assert got["roofline"]["useful_fraction"] == 1.0
    assert (got["wire_bytes"], got["collective_counts"]) == (0.0, {})
    assert perfbridge.perf_record(torch.matmul, (a, b))[
        "roofline_fraction"] is None


def test_attach_to_span_stores_the_record(monkeypatch):
    monkeypatch.setattr(obs.registry(), "enabled", True)
    a = torch.zeros((8, 8))
    with spans._fresh_trace():
        with obs.span("mm") as sp:
            rec = perfbridge.attach_to_span(sp, torch.matmul, (a, a))
        assert sp.args["perf"] is rec
    monkeypatch.setattr(obs.registry(), "enabled", False)
    with obs.span("off") as sp:
        assert perfbridge.attach_to_span(sp, torch.matmul, (a, a))[
            "counted_flops"] == 1024


# ------------------------------------------------------------- hooks ------

@pytest.fixture
def fake_builds(monkeypatch):
    """``build.load`` with a fake build (one nvcc run per new library) and
    a fake library; fresh counters and an armed hook."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "events",
                        {"builds": 0, "loads": 0, "seconds": 0.0})

    def fake_build_all():
        build.events["builds"] += 1
        return [build.BuildResult("k", Path("k.so"), 0.2, "")]

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(kernelhooks, "compile_count", 0)
    monkeypatch.setattr(kernelhooks, "compile_seconds", 0.0)
    kernelhooks.install()
    yield
    kernelhooks.install()


def test_a_span_splits_its_wall_into_build_and_execute(fake_builds,
                                                       monkeypatch):
    reg = obs.MetricsRegistry(enabled=True)
    saved = obs.set_registry(reg)
    try:
        with spans._fresh_trace():
            with obs.span("first") as first:
                build.load("k")
            with obs.span("later") as later:
                build.load("k")
            events = obs.trace_events()
    finally:
        obs.set_registry(saved)
    assert first.n_compiles == 2 and first.compile_s > 0.0
    assert first.execute_s == pytest.approx(first.wall_s - first.compile_s)
    assert (later.n_compiles, later.compile_s) == (0, 0.0)
    assert events[0]["args"]["n_compiles"] == 2
    assert reg.value("kernels.builds") == 2
    assert reg.value("kernels.build_seconds") == first.compile_s
    assert kernelhooks.compile_count == 2 and kernelhooks.installed()


def test_disarmed_hooks_count_nothing(fake_builds):
    kernelhooks.disarm()
    assert not kernelhooks.installed()
    snap = kernelhooks.CompileSnapshot()
    build.load("k")
    assert snap.delta() == (0, 0.0)
    assert build.events == {"builds": 1, "loads": 1,
                            "seconds": build.events["seconds"]}
    build._libs.clear()
    t = bench.measure(lambda: build.load("k"), n=1, warmup=0)
    assert t.n_recompiles == 2 and kernelhooks.installed()


def test_launch_counters_read_the_wrappers_dicts(monkeypatch):
    """The registry's ``kernels.launches{kernel}`` follow the wrappers'
    dicts at every snapshot and delta (a reset count restarts)."""
    for mod in (el, fa, sk, rk):
        monkeypatch.setattr(mod, "launches", dict.fromkeys(mod.launches, 0))
    monkeypatch.setattr(kernelhooks, "_published", {})
    reg = obs.MetricsRegistry(enabled=True)
    saved = obs.set_registry(reg)
    try:
        snap = kernelhooks.snapshot()
        fa.launches["flash_attention"] += 3
        rk.launches["rmsnorm"] += 2
        snap.delta()
        rk.reset_launches()
        rk.launches["rmsnorm"] += 1
        assert kernelhooks.publish_launches()["rmsnorm"] == 1
        bench.measure(lambda: fa.launches.update(flash_attention=5), n=1,
                      warmup=0)
    finally:
        obs.set_registry(saved)
    assert reg.value("kernels.launches", kernel="flash_attention") == 5
    assert reg.value("kernels.launches", kernel="rmsnorm") == 3
    assert set(kernelhooks.launch_counts()) == {
        *el.KERNELS, *fa.KERNELS, *sk.KERNELS, *rk.KERNELS}


# ------------------------------------------------ chip_smoke rehearsals ---

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _opaque(mod, name, plain, terms):
    """A fake of kernel ``name``: its plain version run out of sight of
    the counting modes (as a card kernel is), counted and reported as the
    wrapper does."""
    from torch.utils._python_dispatch import _disable_current_modes

    def fake(*args, **kw):
        with _disable_current_modes():
            out = plain(*args, **kw)
        mod.launches[name] += 1
        if counts.ACTIVE:
            counts.report_kernel(name, terms(*args, **kw))
        return out
    return fake


def _card_kernels(monkeypatch):
    """K1, K5, K6 and K7 swapped for opaque fakes and routed as on the
    card; the card's memory and sync calls stubbed."""
    def attn_terms(q, k, v, causal=True):
        return roofline.flash_attention_terms(*q.shape, q.dtype, causal)

    def ssd_terms(x, B, C, dt, A, D, chunk, *a, **kw):
        b, L, H, P = x.shape
        return roofline.ssd_scan_terms(b, L, H, P, B.shape[-1],
                                       min(chunk, L), x.dtype)

    def rms_terms(x, w, eps=1e-6):
        return roofline.rmsnorm_terms(x.numel() // x.shape[-1], x.shape[-1],
                                      x.dtype)

    def k1_terms(x_i, x_j, com):
        return roofline.edge_latency_dense_terms(*x_i.shape, com.shape[0])

    for mod in (el, fa, sk, rk):
        monkeypatch.setattr(mod, "launches", dict.fromkeys(mod.launches, 0))
    monkeypatch.setattr(fa, "flash_attention", _opaque(
        fa, "flash_attention", ref.flash_attention_plain, attn_terms))
    monkeypatch.setattr(sk, "ssd_scan", _opaque(
        sk, "ssd_scan", ref.ssd_scan_plain, ssd_terms))
    monkeypatch.setattr(rk, "rmsnorm", _opaque(
        rk, "rmsnorm", ref.rmsnorm_plain, rms_terms))
    monkeypatch.setattr(el, "edge_latency_dense", _opaque(
        el, "edge_latency_dense", ref.edge_latency_dense_plain, k1_terms))
    from torch._subclasses.fake_tensor import FakeTensor
    monkeypatch.setattr(dispatch, "_plan", lambda kind, what, t: "plain"
                        if isinstance(t[0], FakeTensor) else "cuda")
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_1_3b", "zamba2_1_2b"])
def test_chip_smoke_perf_lm_phase_rehearses_on_the_cpu(monkeypatch, capsys,
                                                       arch):
    """chip_smoke.py's perf record of one lm_score shard at a smoke config:
    the card route (opaque kernels reporting their terms) against the
    plain route counted on fake CPU tensors, with every bar of the
    phase."""
    cs = _chip_smoke()
    _card_kernels(monkeypatch)
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm":
        cfg = cfg.replace(attention_impl="pallas")
    out = cs.perf_lm_phase(torch, np, torch.device("cpu"), cfg, 3, 16)
    rec = out["record"]
    want = {"olmo_1b": {"flash_attention"},
            "mamba2_1_3b": {"ssd_scan", "rmsnorm"},
            "zamba2_1_2b": {"flash_attention", "ssd_scan", "rmsnorm"}}[arch]
    assert set(rec["kernels"]) == want
    assert rec["roofline"]["model_flops"] > 0 and out["share"] > 0
    assert f"perf_record lm_score {cfg.name}" in capsys.readouterr().out


def test_chip_smoke_perf_dispatch_phase_rehearses_on_the_cpu(monkeypatch,
                                                             capsys):
    """The perf record of a serve_dense dispatch at V 64 on the CPU: S K1
    launches reported, equal to the plain version's count on the meta
    device."""
    from repro_torch.core.graph import random_dag
    from repro_torch.sim import BatchedEvaluator

    cs = _chip_smoke()
    _card_kernels(monkeypatch)
    monkeypatch.setattr(dispatch, "plan_edge_kernel", lambda *a: "cuda")
    rng = np.random.default_rng(0)
    graph = random_dag(6, 0.4, rng)
    V, S, P = 64, 3, 16
    pack = rng.uniform(0.5, 2.0, (S, V, V)).astype(np.float32)
    xs = rng.dirichlet(np.ones(V), (P, 6)).astype(np.float32)
    ev = BatchedEvaluator.shared(graph, device="cpu")
    rec = cs.perf_dispatch_phase(torch, np, torch.device("cpu"), ev, xs,
                                 pack, 0.3, 0.7)
    assert rec["kernels"]["edge_latency_dense"]["launches"] == S
    assert rec["measured_s"] > 0 and rec["n_recompiles"] == 0
    assert "perf_record serve_dense" in capsys.readouterr().out


def test_chip_smoke_hook_overhead_phase_rehearses_on_the_cpu(monkeypatch,
                                                             capsys):
    """The disarmed-hooks gate with a fake dispatch on a clock the
    dispatch advances: the stubs go in for the control samples only and
    come out after; a dispatch 20 % slower with the hooks fails the
    gate."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    clock = [0.0]
    monkeypatch.setattr(cs, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    seen = []

    def fn(slowdown=1.0):
        hooked = (dispatch.kernel_scope is counts.kernel_scope,
                  el.counts is counts)
        seen.append(hooked)
        dispatch.rmsnorm(torch.ones((4, 8)), torch.ones(8))
        clock[0] += slowdown if all(hooked) else 1.0

    out = cs.hook_overhead_phase(torch, fn, samples=3, calls=2)
    assert set(seen) == {(True, True), (False, False)}
    assert dispatch.kernel_scope is counts.kernel_scope and \
        el.counts is counts
    assert out["ratio"] == 1.0
    assert len(out["hooked"]) == len(out["control"]) == 3
    assert "hook_overhead" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="disarmed hooks cost"):
        cs.hook_overhead_phase(torch, lambda: fn(1.2), samples=3, calls=1)
    assert dispatch.kernel_scope is counts.kernel_scope


def test_chip_smoke_compile_span_phase_rehearses_on_the_cpu(monkeypatch,
                                                            tmp_path,
                                                            capsys):
    """The build-span phase on the CPU: K7's library 'built' in a fresh
    directory by a fake nvcc (the other libraries copied in), recorded by
    the span and by bench.measure, none on a later call; the build
    directory, the loaded library and the telemetry switch restored."""
    cs = _chip_smoke()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    build.BUILD_DIR.mkdir()
    for src in build.CSRC.glob("*.cu"):
        if src.stem != "rmsnorm":
            build._lib_path(src).write_text("lib")
            build._lib_path(src).with_suffix(".log").write_text("")
    monkeypatch.setattr(build, "_libs", {"rmsnorm": "the loaded library"})
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")

    class Proc:
        returncode = 0

        def __init__(self, argv, **kw):
            Path(argv[argv.index("-o") + 1]).write_text("built")

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        rmsnorm_launch=types.SimpleNamespace(),
        rmsnorm_error_string=types.SimpleNamespace()))
    bound = object()
    monkeypatch.setattr(rk, "_bound", bound)

    def fake_rmsnorm(x, w, eps=1e-6):
        rk._lib()
        return ref.rmsnorm_plain(x, w, eps)

    monkeypatch.setattr(rk, "rmsnorm", fake_rmsnorm)
    saved = obs.set_registry(obs.MetricsRegistry(enabled=False))
    try:
        out = cs.compile_span_phase(torch, torch.device("cpu"))
    finally:
        obs.set_registry(saved)
    assert out["first"] > 0 and out["later"] == 0.0
    assert build.BUILD_DIR == tmp_path / "_build" and rk._bound is bound
    assert build._libs["rmsnorm"] == "the loaded library"
    assert not obs.enabled()
    assert [p.name for p in build.BUILD_DIR.iterdir()
            if p.name.startswith("fresh")] == []
    assert "compile_span" in capsys.readouterr().out
