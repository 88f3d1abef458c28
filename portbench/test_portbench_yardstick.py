"""The yardstick's arithmetic on synthetic inputs: window rates, the idle
share and gaps, the spread, the frozen counts,
the seeded weights, the trace's breakdown, and the check on JAX and the
JAX package."""

import math

import pytest
import torch

from portbench import counts, devtrace, guard, stats, weights
from portbench.families import ssm


def test_window_rate_runs_to_the_last_completed_unit():
    units = [(100, 1.5), (100, 2.5), (50, 4.0)]
    assert stats.window_rate(units, 0.0) == pytest.approx(250 / 4.0)
    assert stats.window_rate(units, 1.0) == pytest.approx(250 / 3.0)
    with pytest.raises(ValueError):
        stats.window_rate([], 0.0)


def test_idle_share_and_gaps_from_intervals():
    ops = [(0.1, 0.3), (0.2, 0.4), (0.6, 0.7), (0.95, 1.5)]
    assert stats.busy(ops, 0.0, 1.0) == pytest.approx(0.45)
    gaps = stats.idle_gaps(ops, 0.0, 1.0)
    assert [tuple(round(x, 6) for x in g) for g in gaps] == \
        [(0.0, 0.1), (0.4, 0.6), (0.7, 0.95)]
    assert stats.busy([], 0.0, 1.0) == 0.0
    assert stats.idle_gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, _, q3 = __import__("statistics").quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / 10.0)


def test_k6_terms_at_the_scoring_shard():
    # 11 rows of 2048, 64 heads of 64, state 128, chunk 256, bf16: 0.115 ms
    t = counts.ssd_scan_terms(11, 2048, 64, 64, 128, 256, "bfloat16")
    assert t.seconds == pytest.approx(1.1534e-4, rel=1e-4)
    assert t.bytes / counts.HBM_BW > t.flops / t.peak
    b = counts.ssd_scan_bwd_terms(16, 2048, 64, 64, 128, 256, "bfloat16")
    assert b.seconds == pytest.approx(2.5541e-4, rel=1e-4)


def _sizes():
    return {"family": "ssm", "n_layers": 48, "d_model": 2048,
            "vocab": 50280, "vocab_pad": 256, "ssm_state": 128,
            "ssm_expand": 2, "ssm_head_dim": 64, "ssm_conv": 4,
            "ssm_chunk": 256, "act_dtype": "bfloat16"}


def test_model_flops_count_no_embedding():
    m = _sizes()
    mm = ssm.matmul_params(m)
    assert mm == 48 * (2048 * (2 * 4096 + 256 + 64) + 4096 * 2048) \
        + 2048 * 50280
    fwd = ssm.model_flops(m, 1, 2048, "forward")
    scan = 48 * counts.ssd_scan_terms(1, 2048, 64, 64, 128, 256,
                                      "bfloat16").flops
    assert fwd == pytest.approx(2 * mm * 2048 + scan)
    bwd = 48 * counts.ssd_scan_bwd_terms(1, 2048, 64, 64, 128, 256,
                                         "bfloat16").flops
    assert ssm.model_flops(m, 1, 2048, "train") == pytest.approx(
        3 * 2 * mm * 2048 + scan + bwd)


def test_weights_are_seeded_and_made_again_by_group():
    m = _sizes()
    m.update(n_layers=3, d_model=32, vocab=100, ssm_state=8, ssm_head_dim=8)
    cpu = torch.device("cpu")
    a = weights.make_group(m, 2**40 + 7, "blocks.1", cpu)
    b = weights.make_group(m, 2**40 + 7, "blocks.1", cpu)
    c = weights.make_group(m, 2**40 + 8, "blocks.1", cpu)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.1.wz"], c["blocks.1.wz"])
    assert torch.allclose(a["blocks.1.A_log"],
                          torch.log(torch.linspace(1, 16, 8)))
    assert weights.padded_vocab(m) == 256
    assert weights.groups(m) == ["embed", "blocks.0", "blocks.1",
                                 "blocks.2", "head"]
    named = {n: torch.empty(s) for g in weights.groups(m)
             for n, s, _ in weights.leaves(m, g)}
    weights.load_into(named, m, 3)
    assert float(named["head"].std()) == pytest.approx(32 ** -0.5, rel=0.1)
    named.pop("head")
    with pytest.raises(ValueError):
        weights.load_into(named, m, 3)


@pytest.mark.parametrize("names,caught", [
    (["repro_torch", "repro_torch.models.mamba2", "numpy"], []),
    (["repro_torch", "repro.core"], ["repro.core"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"], ["jax", "jax.numpy",
                                                 "jaxlib.xla_client"]),
    (["flax.linen", "jaxtyping", "reproducible"], ["flax.linen"]),
    (["repro"], ["repro"]),
])
def test_the_check_on_jax_and_the_jax_package(names, caught):
    assert guard.forbidden_modules(names) == caught


def test_breakdown_groups_kernels_and_names_idle_gaps():
    ops = [("ssd_scan_output_kernel", 0.0, 1.0),
           ("ampere_bf16_s16816gemm", 1.0, 1.5),
           ("rmsnorm_rows_kernel<8>", 2.0, 2.1),
           ("void at::native::vectorized_elementwise_kernel", 2.1, 2.2)]
    trace = devtrace.DeviceTrace(ops, 0.0, 3.0)
    spans = devtrace.Spans()
    spans.add("engine.run_batch", 0.0, 3.0)
    spans.add("op.dq_check", 1.5, 2.0)
    out = devtrace.breakdown(trace, spans, 0.0, 3.0)
    assert out["device_ops"][0] == ["K6", 1.0]
    got = dict(out["device_ops"])
    assert got["bf16 GEMM"] == pytest.approx(0.5)
    assert got["K7"] == pytest.approx(0.1)
    gaps = dict(out["idle_gaps"])
    assert gaps["op.dq_check"] == pytest.approx(0.5)
    assert gaps["engine.run_batch"] == pytest.approx(0.8)
    assert math.isclose(sum(gaps.values()), 1.3)
