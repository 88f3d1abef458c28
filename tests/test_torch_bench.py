"""The port's timing harness (``repro_torch.obs.bench``) against the
semantics of ``repro.obs.bench``: warmup calls are not timed, the headline
is the median, ``row()`` has the reference's keys, and a kernel build or
load inside the timed region is counted as its compile."""

import dataclasses
import itertools
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.obs import bench as jax_bench  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import bench  # noqa: E402


def _clock(monkeypatch, durations):
    """perf_counter returning start/stop pairs that are ``durations``
    apart."""
    ticks = itertools.chain.from_iterable((10.0 * i, 10.0 * i + d)
                                          for i, d in enumerate(durations))
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))


def test_warmup_is_not_timed_and_the_headline_is_the_median(monkeypatch):
    calls = []
    _clock(monkeypatch, [0.5, 0.1, 0.9, 0.2, 0.3])
    t = bench.measure(lambda: calls.append(1) or len(calls), n=5, warmup=2)
    assert len(calls) == 7 and t.result == 7
    assert t.times == pytest.approx([0.5, 0.1, 0.9, 0.2, 0.3])
    assert t.seconds == pytest.approx(0.3)
    assert t.mean_s == pytest.approx(0.4)
    assert (t.min_s, t.max_s) == pytest.approx((0.1, 0.9))
    assert (t.n_recompiles, t.compile_s) == (0, 0.0)


def test_row_has_the_references_keys():
    t = bench.measure(lambda: torch.ones(3).sum(), n=3, warmup=0)
    ref = jax_bench.Timing(times=[1.0], n_recompiles=0, compile_s=0.0)
    assert list(t.row()) == list(ref.row())
    assert t.row()["n_timed"] == 3
    assert [f.name for f in dataclasses.fields(bench.Timing)] == \
        [f.name for f in dataclasses.fields(jax_bench.Timing)]
    assert obs.measure is bench.measure and obs.Timing is bench.Timing


def test_measure_refuses_no_timed_calls():
    with pytest.raises(ValueError, match="n >= 1"):
        bench.measure(lambda: None, n=0)


def test_a_kernel_build_in_the_timed_region_is_counted(monkeypatch):
    """The first call builds (one nvcc run) and opens a library; later
    calls reuse it.  Warmed up, nothing is counted; cold, both are."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "events",
                        {"builds": 0, "loads": 0, "seconds": 0.0})

    def fake_build_all():
        build.events["builds"] += 1
        return [build.BuildResult("k", Path("k.so"), 0.2, "")]

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    cold = bench.measure(lambda: build.load("k"), n=3, warmup=0)
    assert cold.n_recompiles == 2 and cold.compile_s > 0.0
    warm = bench.measure(lambda: build.load("k"), n=3, warmup=1)
    assert (warm.n_recompiles, warm.compile_s) == (0, 0.0)
    with pytest.raises(ValueError, match="no kernel source"):
        build.load("missing")
    assert build.events["loads"] == 1


def test_time_once_returns_seconds_and_result(monkeypatch):
    _clock(monkeypatch, [0.25])
    secs, out = bench.time_once(lambda: torch.arange(4))
    assert secs == pytest.approx(0.25) and out.tolist() == [0, 1, 2, 3]


def test_block_looks_for_card_tensors_in_nested_results():
    @dataclasses.dataclass
    class Res:
        a: torch.Tensor
        rest: dict

    out = Res(torch.ones(2), {"b": [torch.zeros(1), (torch.ones(1),)]})
    assert bench._cuda_devices(out, set()) == set()   # all on the CPU
    assert bench._call_blocked(lambda: out, True) is out
