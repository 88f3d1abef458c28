"""K6 (the Mamba2 SSD chunked scan), K7 (RMSNorm) and the Mamba2 forward:
the port's plain versions and model against the JAX package on the same
inputs, plus the device routes, launch counts, config, accounting,
converter and roofline terms of the slice.

Inputs are drawn with numpy and handed to both sides.  Tolerances:

* ``ssd_scan_plain`` against ``repro.models.mamba2.ssd_chunked`` at the
  same chunk, float32: ≤1e-5 relative (max |err| / max |want|); the two
  compute the same chunked form op for op.  Also on slow-decay inputs over
  ≥ 8 chunks, where the states older than one chunk carry more than 5 %
  of y, so a scan that lost them would fail.
* ``ssd_scan_plain`` against the Pallas kernel in interpret mode
  (``ops.ssd_scan(chunk=16, head_block=2)``) and against the per-token
  oracle ``ref.ssd_ref``: tests/test_kernels.py's own bars (atol 2e-3 for
  float32, 5e-2 for bfloat16, rtol 5e-2).
* ``rmsnorm_plain`` against ``rmsnorm_pallas(interpret=True)`` and
  ``layers.rms_norm``: float32 within 1e-6 relative; bfloat16 within one
  bfloat16 ulp of each value (both round one float32 result).
* The Mamba2 smoke forward (2 layers, d 64, 16 heads of 8, N 16, chunk 8)
  against JAX ``Mamba2LM.forward`` on the same parameters: float32
  activations ≤1e-5 relative in the logits (measured ≤6e-7); bfloat16
  activations ≤2e-2 (each side rounds activations to bfloat16 at its own
  places; measured 7.7e-3 at S = 16 and 1.05e-2 at S = 20).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.api import analytic_flops as jax_flops  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.models.api import count_params as jax_count  # noqa: E402
from repro.models.mamba2 import ssd_chunked  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import (analytic_flops, build_model,  # noqa: E402
                                count_params, layers)
from repro_torch.models.api import ModelConfig  # noqa: E402
from repro_torch.models.mamba2 import Mamba2LM, causal_conv  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
try:
    import chip_smoke  # noqa: E402
finally:
    sys.path.pop(0)

REL = {"float32": 1e-5, "bfloat16": 2e-2}
# tests/test_kernels.py's SSD shapes (b, L, H, P, N)
SSD_SHAPES = [(2, 64, 8, 16, 16), (1, 128, 4, 32, 8), (2, 32, 2, 8, 4)]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _ssd_inputs(b, L, H, P, N, dtype, seed):
    """x, B, C rounded to ``dtype`` once (as float32 arrays), dt, A, D
    float32: the distributions of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    B = (rng.standard_normal((b, L, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, L, N)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        x, B, C = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (x, B, C))
    dt = (np.logaddexp(rng.standard_normal((b, L, H)), 0) * 0.5) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, B, C, dt, A, D


def _torch_ssd(arrs, dtype):
    x, B, C, dt, A, D = (torch.from_numpy(a) for a in arrs)
    t = getattr(torch, dtype)
    return x.to(t), B.to(t), C.to(t), dt, A, D


# -------------------------------------------------------------- K6 --------

@pytest.mark.parametrize("b,L,H,P,N,chunk", [
    (2, 64, 8, 16, 16, 16), (1, 128, 4, 32, 8, 32), (2, 20, 5, 8, 16, 8),
    (1, 100, 3, 8, 8, 256), (1, 7, 2, 4, 4, 3)])
def test_ssd_plain_matches_ssd_chunked(b, L, H, P, N, chunk):
    """float32, the same chunk: ragged last chunks (L = 20 with chunk 8,
    L = 7 with 3) and a chunk longer than L (one chunk of L rows)."""
    arrs = _ssd_inputs(b, L, H, P, N, "float32", seed=L + H)
    want, _ = ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    got = ref.ssd_scan_plain(*_torch_ssd(arrs, "float32"), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, L, H, P)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("b,L,H,P,N", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_interpret_and_oracle(b, L, H, P, N, dtype):
    arrs = _ssd_inputs(b, L, H, P, N, dtype, seed=b * L + H)
    jx, jB, jC = (jnp.asarray(a, dtype) for a in arrs[:3])
    jrest = [jnp.asarray(a) for a in arrs[3:]]
    kernel = jax_ops.ssd_scan(jx, jB, jC, *jrest, chunk=16, head_block=2,
                              interpret=True)
    oracle, _ = jax_ref.ssd_ref(jx, jB, jC, *jrest)
    got = ref.ssd_scan_plain(*_torch_ssd(arrs, dtype), chunk=16)
    assert got.dtype == getattr(torch, dtype)
    tol = dict(atol=5e-2 if dtype == "bfloat16" else 2e-3, rtol=5e-2)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def _slow_decay(arrs, seed):
    """dt = softplus(z − 6), A = −0.05·(1 + 0.1u): over a chunk exp(total)
    stays near 1, so states older than one chunk carry weight."""
    x, B, C, dt, A, D = arrs
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.standard_normal(dt.shape) - 6.0, 0) \
        .astype(np.float32)
    A = (-0.05 * (1.0 + 0.1 * rng.random(A.shape))).astype(np.float32)
    return x, B, C, dt, A, D


@pytest.mark.parametrize("b,L,H,P,N,chunk", [
    (1, 256, 3, 16, 32, 32), (2, 250, 2, 8, 16, 32), (1, 1024, 2, 16, 32, 128)])
def test_ssd_plain_matches_ssd_chunked_with_slow_decay(b, L, H, P, N, chunk):
    """float32 over ≥ 8 chunks (ragged at L = 250) with slow decay, where
    the states older than one chunk carry more than 5 % of y: the two
    still agree within 1e-5."""
    arrs = _slow_decay(_ssd_inputs(b, L, H, P, N, "float32", seed=L),
                       seed=L + 1)
    assert -(-L // chunk) >= 8
    args = _torch_ssd(arrs, "float32")
    assert chip_smoke.older_state_share(torch, ref.ssd_scan_plain,
                                       (*args, chunk)) > 0.05
    want, _ = ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    got = ref.ssd_scan_plain(*args, chunk=chunk)
    assert _rel(got.numpy(), want) <= 1e-5


def test_ssd_plain_ragged_length_matches_the_oracle():
    """L = 20 with chunk 8: the reference pads the last chunk with zeros;
    the per-token oracle has no chunks at all."""
    arrs = _ssd_inputs(2, 20, 3, 8, 8, "float32", seed=5)
    oracle, _ = jax_ref.ssd_ref(*map(jnp.asarray, arrs))
    got = ref.ssd_scan_plain(*_torch_ssd(arrs, "float32"), chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-3,
                               rtol=5e-2)


def test_ssd_plain_refuses_mismatched_operands():
    x, B, C, dt, A, D = _torch_ssd(_ssd_inputs(1, 8, 2, 4, 4, "float32", 0),
                                   "float32")
    with pytest.raises(ValueError, match="disagree"):
        ref.ssd_scan_plain(x, B, C, dt[:, :, :1], A, D, chunk=4)
    with pytest.raises(TypeError, match="dtypes differ"):
        ref.ssd_scan_plain(x, B.bfloat16(), C, dt, A, D, chunk=4)
    with pytest.raises(ValueError, match="chunk"):
        ref.ssd_scan_plain(x, B, C, dt, A, D, chunk=0)
    empty = ref.ssd_scan_plain(x[:, :0], B[:, :0], C[:, :0], dt[:, :0], A,
                               D, chunk=4)
    assert empty.shape == (1, 0, 2, 4)


# -------------------------------------------------------------- K7 --------

@pytest.mark.parametrize("rows,D", [(1, 64), (37, 128), (300, 256),
                                    (5, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_layers(rows, D, dtype):
    rng = np.random.default_rng(rows + D)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy(), dtype)
    got = ref.rmsnorm_plain(tx, torch.from_numpy(w)).float().numpy()
    assert torch.equal(layers.rms_norm(tx, torch.from_numpy(w)),
                       ref.rmsnorm_plain(tx, torch.from_numpy(w)))
    for want in (rmsnorm_pallas(jx, jnp.asarray(w), interpret=True),
                 jax_layers.rms_norm(jx, jnp.asarray(w))):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            assert _rel(got, want) <= 1e-6
        else:   # one bf16 ulp of each value: 2^-7 of its magnitude
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert np.all(np.abs(got - want) <= ulp)


def test_rms_norm_without_a_weight_is_the_plain_math():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 16))
                         .astype(np.float32))
    np.testing.assert_allclose(
        layers.rms_norm(x, None).numpy(),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x.numpy()), None)),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------- routes and counts ------

def test_routes_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    monkeypatch.setattr(sk, "ssd_scan", refuse)
    monkeypatch.setattr(rk, "rmsnorm", refuse)
    args = _torch_ssd(_ssd_inputs(1, 12, 3, 8, 4, "float32", 1), "float32")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32))
                         .astype(np.float32))
    w = torch.ones(32)
    reg = obs.registry()
    was = reg.enabled
    obs.enable()
    try:
        before = {k: reg.value("kernels.dispatch.plans", kind=k,
                               impl="plain") for k in ("ssd_scan", "rmsnorm")}
        y = dispatch.ssd_scan(*args, chunk=4)
        n = dispatch.rmsnorm(x, w)
        for k in ("ssd_scan", "rmsnorm"):
            assert reg.value("kernels.dispatch.plans", kind=k,
                             impl="plain") == before[k] + 1
            assert reg.value("kernels.dispatch.plans", kind=k,
                             impl="cuda") == 0
    finally:
        reg.enabled = was
    assert torch.equal(y, ref.ssd_scan_plain(*args, chunk=4))
    assert torch.equal(n, ref.rmsnorm_plain(x, w))
    assert sk.launches == {"ssd_scan": 0, "ssd_scan_bwd": 0}
    assert rk.launches == {"rmsnorm": 0, "rmsnorm_bwd": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    args = _torch_ssd(_ssd_inputs(1, 8, 2, 4, 4, "float32", 0), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.ssd_scan(*args, chunk=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rk.rmsnorm(torch.zeros((2, 8)), torch.ones(8))
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="span devices"):
        dispatch.rmsnorm(torch.zeros((2, 8)), meta[0])
    with pytest.raises(ValueError, match="no rmsnorm route"):
        dispatch.rmsnorm(meta, meta[0])
    # per kernel, the shared memory of csrc/ssd_scan.cu's layouts: the
    # serving shape fits every CTA (two chunk-state and two output CTAs per
    # SM); the float32 route refuses a 1024-row chunk, the bf16 passes a
    # chunk of 16 384 rows
    assert sk.smem_bytes(128, 64, 256) == {
        "cuda_cores_f32": 213_760, "chunk_states": 68_608,
        "output": 87_552}
    assert 2 * max(sk.smem_bytes(128, 64, 256)[k]
                   for k in ("chunk_states", "output")) <= 228 * 1024
    assert sk.smem_bytes(128, 64, 1024)["cuda_cores_f32"] > sk.SMEM_LIMIT
    assert sk.smem_bytes(128, 64, 1024)["output"] <= sk.SMEM_LIMIT
    assert sk.smem_bytes(128, 64, 16_384)["output"] > sk.SMEM_LIMIT
    assert sk.launches == {"ssd_scan": 0, "ssd_scan_bwd": 0} and \
        rk.launches == {"rmsnorm": 0, "rmsnorm_bwd": 0}
    assert not any(sk.route_launches.values())


def test_ssd_route_is_the_dtype():
    """bfloat16 operands take the tensor-core passes, float32 the CUDA
    cores; every route and pass has a counter, the backward's four passes
    too."""
    assert sk.route(torch.bfloat16) == "tensor_cores"
    assert sk.route(torch.float32) == "cuda_cores_f32"
    assert set(sk.route_launches) == {*sk.ROUTES, *sk.PASSES,
                                      *sk.BWD_PASSES}


def test_roofline_terms_of_the_serving_shapes():
    """One lm_score shard of Mamba2-1.3B: 11 rows × 2048 tokens."""
    t = roofline.ssd_scan_terms(11, 2048, 64, 64, 128, 256, torch.bfloat16)
    per_chunk = 2 * 256 ** 2 * 128 + 256 * 257 * 64 * 64 \
        + 4 * 256 * 128 * 64 * 64
    assert t.flops == 11 * 8 * per_chunk
    assert t.bytes == 11 * 2048 * (2 * 64 * 64 * 2 + 2 * 128 * 2 + 4 * 64) \
        + 8 * 64
    assert t.bound_by == "bytes" and abs(t.memory_s - 1.1534e-4) < 1e-8
    for D, ms in ((2048, 0.0551), (4096, 0.1102)):
        t = roofline.rmsnorm_terms(22528, D, torch.bfloat16)
        assert t.bound_by == "bytes"
        assert abs(t.step_time_s * 1e3 - ms) < 1e-4


# ------------------------------------------------------------ Mamba2 ------

def _port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jax_params(act: str):
    cfg = jax_smoke("mamba2_1_3b").replace(act_dtype=act)
    params = jax_build(cfg).init_params(jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("S", [16, 20])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_mamba2_forward_matches_jax(S, act):
    cfg, params, tree = _jax_params(act)
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S))
    want, _ = jax_build(cfg).forward(params,
                                     {"tokens": jnp.asarray(toks, jnp.int32)})
    model = convert.mamba2_lm_from_arrays(_port_config(cfg), tree,
                                          device="cpu")
    with torch.inference_mode():
        got, aux = model({"tokens": toks})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (2, S, cfg.vocab_padded)
    assert _rel(got.numpy(), np.asarray(want)) <= REL[act]


def test_mamba2_forward_runs_k6_and_k7_per_layer(monkeypatch):
    """Through the routes: one SSD scan per layer, and 2 RMSNorms per layer
    plus the final norm."""
    cfg, _, tree = _jax_params("float32")
    model = convert.mamba2_lm_from_arrays(_port_config(cfg), tree,
                                          device="cpu")
    calls = {"ssd_scan": 0, "rmsnorm": 0}
    ssd, rms = dispatch.ssd_scan, dispatch.rmsnorm

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dispatch, "ssd_scan", count("ssd_scan", ssd))
    monkeypatch.setattr(dispatch, "rmsnorm", count("rmsnorm", rms))
    with torch.inference_mode():
        model({"tokens": np.zeros((1, 9), np.int64)})
    assert calls == {"ssd_scan": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}


def test_causal_conv_matches_jax():
    from repro.models.mamba2 import _causal_conv
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        tu = torch.from_numpy(u).to(getattr(torch, dtype))
        got = causal_conv(tu, torch.from_numpy(w), torch.from_numpy(b))
        want, _ = _causal_conv(jnp.asarray(tu.float().numpy(), dtype),
                               jnp.asarray(w), jnp.asarray(b))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_mamba2_config_and_accounting_match_jax():
    jcfg = jax_config("mamba2_1_3b")
    cfg = get_config("mamba2-1.3b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_smoke_config("mamba2_1_3b")) == \
        dataclasses.asdict(jax_smoke("mamba2_1_3b"))
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv, cfg.ssm_chunk,
            cfg.vocab_padded) == (48, 2048, 4096, 64, 64, 128, 4, 256, 50432)
    assert (cfg.pdtype, cfg.adtype) == (torch.float32, torch.bfloat16)
    total, active = count_params(cfg)
    assert (total, active) == jax_count(jcfg)
    assert 1.2e9 < total < 1.6e9
    for mode in ("train", "prefill", "decode"):
        assert analytic_flops(cfg, 2048, 128, mode) == \
            jax_flops(jcfg, 2048, 128, mode)


def test_mamba2_parameters_mirror_the_jax_tree():
    cfg, _, tree = _jax_params("float32")
    model = Mamba2LM(_port_config(cfg), device="cpu")
    blk = model.blocks[0]
    for name in convert.MAMBA2_LEAVES:
        assert tuple(getattr(blk, name).shape) == \
            tree["blocks"][name].shape[1:], name
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))


def test_mamba2_init_params_is_seeded_and_scaled():
    cfg = get_smoke_config("mamba2_1_3b")
    a = Mamba2LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    b = Mamba2LM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    blk = a.blocks[0]
    assert abs(float(blk.out_proj.std()) * cfg.d_inner ** 0.5 - 1) < 0.1
    assert torch.allclose(-torch.exp(blk.A_log),
                          -torch.linspace(1.0, 16.0, cfg.ssm_heads))
    assert float(blk.dt_bias.max()) == -2.0 and float(blk.D.min()) == 1.0
    assert float(blk.conv_b.abs().max()) == 0.0


def test_mamba2_converter_refuses_a_mismatched_tree():
    cfg, _, tree = _jax_params("float32")
    port = _port_config(cfg)
    blocks = dict(tree["blocks"])
    bad = dict(tree, blocks=dict(blocks, conv_w=blocks["conv_w"][:, :-1]))
    with pytest.raises(ValueError, match="conv_w: shape"):
        convert.mamba2_lm_from_arrays(port, bad, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        convert.mamba2_lm_from_arrays(port.replace(n_layers=3), tree,
                                      device="cpu")
    with pytest.raises(ValueError, match="not a Mamba2LM tree"):
        convert.mamba2_lm_from_arrays(port, dict(tree, extra=1),
                                      device="cpu")
    missing = {k: v for k, v in blocks.items() if k != "dt_bias"}
    with pytest.raises(ValueError, match="not a Mamba2LM tree"):
        convert.mamba2_lm_from_arrays(port, dict(tree, blocks=missing),
                                      device="cpu")


def test_build_model_returns_mamba2_and_defaults_to_the_card(monkeypatch):
    smoke = get_smoke_config("mamba2_1_3b")
    assert isinstance(build_model(smoke, device="cpu"), Mamba2LM)
    # as the reference, the ssm family ignores moe_experts
    with_experts = build_model(smoke.replace(moe_experts=2), device="cpu")
    assert isinstance(with_experts, Mamba2LM)
    assert [n for n, _ in with_experts.named_parameters()] == \
        [n for n, _ in build_model(smoke, device="cpu").named_parameters()]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(smoke)
