"""The SSD scan's gradient (K6's backward): the port's plain scan, its
hand-written plain backward and the card route's autograd function, against
the JAX package's ``ssd_chunked`` and ``jax.grad`` through it.

The probe inputs are the published initialisation at a small width: b 1,
L 512, H 4, P 8, N 16; x, B, C standard normal; dt = softplus(−2) ≈ 0.127
everywhere (Mamba2's ``dt_bias`` init); A = −linspace(1, 16, H) (its
``A_log`` init).  There the reference exponentiates every in-chunk
difference cum_i − cum_j before masking j > i; above the diagonal the
difference reaches 0.127 · 16 · (Q − 1), which overflows float32 at chunk
64 (≈ 128) and 256 (≈ 518), and the backward multiplies the mask's zero by
inf: dt's and A's gradients are NaN.  The port's plain scan forms the decay
only on and below the diagonal, so its forward is bitwise the old one and
its gradients stay finite.

Tolerances: the plain scan's gradients against ``jax.grad`` ≤1e-5
relative (max |err| / max |want|; the two compute the same ops in float32);
``ssd_scan_bwd_plain`` against float64 autograd through the plain scan
≤1e-10 (the same function in float64, summed in another order).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.mamba2 import ssd_chunked  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402

NAMES = ("x", "B", "C", "dt", "A", "D")


def _probe(L=512, H=4, P=8, N=16, A_hi=16.0, seed=0):
    """The probe inputs (numpy float32) and an upstream gradient of y."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((1, L, H, P)).astype(f)
    B = rng.standard_normal((1, L, N)).astype(f)
    C = rng.standard_normal((1, L, N)).astype(f)
    dt = np.full((1, L, H), np.log1p(np.exp(-2.0)), dtype=f)
    A = -np.linspace(A_hi / 16.0, A_hi, H).astype(f)
    D = rng.standard_normal(H).astype(f)
    dy = rng.standard_normal((1, L, H, P)).astype(f)
    return (x, B, C, dt, A, D), dy


def _smoke(seed=3, b=2, L=20, H=4, P=8, N=16):
    """Inputs at the smoke configs' widths (chunk 8 in their use)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, L, H, P)).astype(f)
    B = (0.5 * rng.standard_normal((b, L, N))).astype(f)
    C = (0.5 * rng.standard_normal((b, L, N))).astype(f)
    dt = (0.5 * np.log1p(np.exp(rng.standard_normal((b, L, H))))).astype(f)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(f)
    D = rng.standard_normal(H).astype(f)
    dy = rng.standard_normal((b, L, H, P)).astype(f)
    return (x, B, C, dt, A, D), dy


_JAX_GRADS: dict = {}


def _jax_grads(ops, dy, chunk):
    """``jax.grad`` of ⟨ssd_chunked(...)[0], dy⟩, kept per inputs and chunk
    (several tests read the probe's)."""
    key = (chunk, dy.tobytes(), *(a.tobytes() for a in ops))
    if key not in _JAX_GRADS:
        def f(*a):
            y, _ = ssd_chunked(*a, chunk)
            return jnp.sum(y * dy)
        _JAX_GRADS[key] = [np.asarray(g) for g in jax.grad(
            f, argnums=tuple(range(6)))(*map(jnp.asarray, ops))]
    return _JAX_GRADS[key]


def _torch_grads(ops, dy, chunk, scan=None):
    leaves = [torch.tensor(a, requires_grad=True) for a in ops]
    y = (scan or ref.ssd_scan_plain)(*leaves, chunk)
    return [g.numpy() for g in torch.autograd.grad(y, leaves,
                                                   torch.tensor(dy))]


def _old_decay(cum, mask):
    """The plain scan's decay before the repair, the reference's: every
    difference exponentiated, then masked."""
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
    return torch.where(mask[None, :, :, None], decay, 0.0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("chunk", [64, 256])
def test_reference_gradient_of_dt_and_A_is_not_finite_at_the_published_chunk(
        chunk):
    """Reference behaviour the port does not mirror: ``jax.grad`` of
    ``ssd_chunked`` at the probe inputs gives NaN or inf in dt's and A's
    gradients at chunk 64 and 256 (x's, B's and C's stay finite)."""
    ops, dy = _probe()
    g = dict(zip(NAMES, _jax_grads(ops, dy, chunk)))
    assert not np.isfinite(g["dt"]).all() and not np.isfinite(g["A"]).all()
    for k in ("x", "B", "C", "D"):
        assert np.isfinite(g[k]).all(), k


@pytest.mark.parametrize("chunk", [64, 256])
def test_plain_scan_gradient_is_finite_where_the_old_form_was_not(
        chunk, monkeypatch):
    """Autograd through ``ssd_scan_plain`` at the probe inputs: every
    gradient finite, and x's, B's and C's within 1e-5 of the reference's
    (which are finite there); the old formulation, swapped back in, gives
    the reference's non-finite dt and A gradients."""
    ops, dy = _probe()
    got = _torch_grads(ops, dy, chunk)
    assert all(np.isfinite(g).all() for g in got)
    want = _jax_grads(ops, dy, chunk)
    for name, g, w in zip(NAMES, got, want):
        if name in ("x", "B", "C", "D"):
            assert _rel(g, w) <= 1e-5, name
    monkeypatch.setattr(ref, "_decay", _old_decay)
    old = dict(zip(NAMES, _torch_grads(ops, dy, chunk)))
    assert not np.isfinite(old["dt"]).all()
    assert not np.isfinite(old["A"]).all()


@pytest.mark.parametrize("chunk", [8, 64, 256])
def test_plain_scan_forward_is_bitwise_the_old_formulation(chunk,
                                                           monkeypatch):
    """The repaired decay leaves the forward bitwise as it was, y and the
    final state, at L 300 (ragged at chunks 8 and 64, shorter than 256)
    on the probe's decays."""
    ops, _ = _probe(L=300)
    args = [torch.tensor(a) for a in ops]
    y, S = ref.ssd_scan_plain(*args, chunk, final_state=True)
    monkeypatch.setattr(ref, "_decay", _old_decay)
    y_old, S_old = ref.ssd_scan_plain(*args, chunk, final_state=True)
    assert torch.equal(y, y_old) and torch.equal(S, S_old)


@pytest.mark.parametrize("chunk, A_hi", [(8, 16.0), (64, 1.0)])
def test_plain_scan_gradient_matches_the_reference_where_it_is_finite(
        chunk, A_hi):
    """Where the reference's gradient is finite — chunk 8 at the published
    A, chunk 64 with |A|·dt small enough that no difference overflows —
    every gradient of the plain scan, dt's and A's too, is within 1e-5 of
    ``jax.grad``'s."""
    ops, dy = _probe(A_hi=A_hi)
    want = _jax_grads(ops, dy, chunk)
    assert all(np.isfinite(w).all() for w in want)
    for name, g, w in zip(NAMES, _torch_grads(ops, dy, chunk), want):
        assert _rel(g, w) <= 1e-5, name


def _wide(b, L, H, P, N, strided, seed):
    rng = np.random.default_rng(seed)
    f = torch.float64
    x = torch.tensor(rng.standard_normal((b, L, H, P)), dtype=f)
    if strided:                # B and C as views of one conv output
        conv = torch.tensor(rng.standard_normal((b, L, H * P + 2 * N)),
                            dtype=f)
        B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    else:
        B = torch.tensor(rng.standard_normal((b, L, N)), dtype=f)
        C = torch.tensor(rng.standard_normal((b, L, N)), dtype=f)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.standard_normal((b, L, H)), dtype=f) - 1.0)
    A = -torch.linspace(1.0, 6.0, H, dtype=f)
    D = torch.tensor(rng.standard_normal(H), dtype=f)
    dy = torch.tensor(rng.standard_normal((b, L, H, P)), dtype=f)
    return (x, B, C, dt, A, D), dy


@pytest.mark.parametrize("b, L, H, P, N, chunk, strided", [
    (2, 20, 3, 4, 5, 8, False),       # ragged L over 3 chunks
    (1, 5, 2, 3, 4, 8, False),        # L < chunk
    (2, 16, 2, 4, 3, 16, False),      # a single chunk
    (1, 300, 2, 4, 6, 64, True),      # strided B and C, ragged
    (2, 40, 5, 8, 16, 8, True),       # strided, whole chunks, H % 4 != 0
])
def test_plain_backward_matches_float64_autograd(b, L, H, P, N, chunk,
                                                 strided):
    """``ssd_scan_bwd_plain``, written out by hand, against float64
    autograd through ``ssd_scan_plain``: every gradient within 1e-10."""
    ops, dy = _wide(b, L, H, P, N, strided, seed=L + H)
    leaves = [t.detach().clone().requires_grad_() for t in ops]
    want = torch.autograd.grad(ref.ssd_scan_plain(*leaves, chunk), leaves,
                               dy)
    got = ref.ssd_scan_bwd_plain(*ops, dy, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g.numpy(), w.numpy()) <= 1e-10, name


def test_plain_backward_keeps_the_operands_dtypes():
    """bfloat16 x, B, C give bfloat16 dx, dB, dC (computed in float32);
    dt, A, D keep float32."""
    ops, dy = _smoke()
    t = [torch.tensor(a) for a in ops]
    bf = [t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(), *t[3:]]
    got = ref.ssd_scan_bwd_plain(*bf, torch.tensor(dy).bfloat16(), 8)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    f32 = ref.ssd_scan_bwd_plain(*t, torch.tensor(dy), 8)
    assert all(_rel(g.float().numpy(), w.numpy()) <= 2e-2
               for g, w in zip(got, f32))


def _counted_card_route(monkeypatch):
    """The card plan for CPU tensors, K6 and its backward swapped for
    counted plain versions; returns the counts."""
    count = {"fwd": 0, "bwd": 0}

    def fwd(x, B, C, dt, A, D, chunk, final_state=False, state_out=None):
        count["fwd"] += 1
        return ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, final_state,
                                  state_out)

    def bwd(x, B, C, dt, A, D, dy, chunk):
        count["bwd"] += 1
        return ref.ssd_scan_bwd_plain(x, B, C, dt, A, D, dy, chunk)

    monkeypatch.setattr(dispatch, "_plan", lambda *a, **k: "cuda")
    monkeypatch.setattr(sk, "ssd_scan", fwd)
    monkeypatch.setattr(sk, "ssd_scan_bwd", bwd)
    return count


def test_k6_card_route_differentiates_through_its_backward(monkeypatch):
    """K6's card route under grad is ``SSDScanFunction``: its forward is the
    wrapper's ``ssd_scan``, its backward ``ssd_scan_bwd`` (here the plain
    versions, counted, on CPU tensors the plan calls "cuda"); the output
    has a ``grad_fn``, the backward runs once, and the gradients are
    ``jax.grad``'s of ``ssd_chunked`` at chunk 8 within 1e-5."""
    count = _counted_card_route(monkeypatch)
    ops, dy = _smoke()
    leaves = [torch.tensor(a, requires_grad=True) for a in ops]
    y = dispatch.ssd_scan(*leaves, 8)
    assert y.grad_fn is not None and count == {"fwd": 1, "bwd": 0}
    got = torch.autograd.grad(y, leaves, torch.tensor(dy))
    assert count == {"fwd": 1, "bwd": 1}
    for name, g, w in zip(NAMES, got, _jax_grads(ops, dy, 8)):
        assert _rel(g.numpy(), w) <= 1e-5, name
    with torch.no_grad():       # without grad the plain wrapper, as before
        assert dispatch.ssd_scan(*leaves, 8).grad_fn is None
    assert count == {"fwd": 2, "bwd": 1}


def test_k6_card_route_refuses_the_final_state_under_grad(monkeypatch):
    """No training path differentiates the final state, so asking for it
    (or for ``state_out``, the prefill's cache) under grad on the card
    raises before any launch; without grad it is returned as before."""
    count = _counted_card_route(monkeypatch)
    ops, _ = _smoke()
    leaves = [torch.tensor(a, requires_grad=True) for a in ops]
    with pytest.raises(RuntimeError, match="final state.*no training path"):
        dispatch.ssd_scan(*leaves, 8, final_state=True)
    with pytest.raises(RuntimeError, match="no training path"):
        dispatch.ssd_scan(*leaves, 8, state_out=torch.zeros(2, 4, 16, 8))
    assert count == {"fwd": 0, "bwd": 0}
    with torch.no_grad():
        y, S = dispatch.ssd_scan(*leaves, 8, final_state=True)
    assert S.shape == (2, 4, 16, 8) and count["fwd"] == 1


def test_k6_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """The backward's wrapper takes CUDA tensors only and launches nothing
    here; its shared memory at the training shape fits a CTA; its
    roofline terms read x, dy, B, C, dt and write their gradients once."""
    ops, dy = _smoke()
    t = [torch.tensor(a) for a in ops]
    before = dict(sk.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.ssd_scan_bwd(*t, torch.tensor(dy), 8)
    assert sk.launches == before
    smem = sk.bwd_smem_bytes(128, 64, 256)
    assert smem == {
        "cuda_cores_f32": {"bwd_states": 8 * 264 + 4 * (2 * 256 + 2 * 32 * 129
                                                        + 2 * 32 * 65),
                           "bwd_chunk": 202_816},
        "tensor_cores": {"bwd_states": 1024 + 6 * 8192 + 12 * 256,
                         "bwd_chunk": 230_976}}
    for way in smem.values():
        assert max(way.values()) <= sk.SMEM_LIMIT
    for way in sk.bwd_smem_bytes(128, 64, 1024).values():
        assert way["bwd_chunk"] > sk.SMEM_LIMIT
    # the bf16 route's partials of <S_c, dS_{c+1}>: one a warp of pass 2
    assert sk.bwd_ssp_count(128, 64) == 64 and sk.bwd_ssp_count(16, 8) == 8
    assert sk.bwd_ssp_count(4, 6) == 32
    terms = roofline.ssd_scan_bwd_terms(4, 2048, 64, 64, 128, 256,
                                        torch.bfloat16)
    assert terms.bytes == 4 * 2048 * (3 * 4096 * 2 + 4 * 128 * 2 + 8 * 64) \
        + 16 * 64
    assert terms.bound_by == "bytes" and abs(terms.memory_s - 6.3854e-5) < 1e-8
    fwd = roofline.ssd_scan_terms(4, 2048, 64, 64, 128, 256, torch.bfloat16)
    assert 2 < terms.flops / fwd.flops < 2.5


# -- chip_smoke's K6 backward phase and the SSM training runs, rehearsed -------

def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _counted_kernels(monkeypatch):
    """K6, its backward, K7 and its backward swapped for counted plain
    versions (the backward also counting its passes, as the wrapper does)
    under the card plan for K5, K6 and K7."""
    from repro_torch.kernels import rmsnorm as rk

    def scan(x, B, C, dt, A, D, chunk, final_state=False, state_out=None):
        sk.launches["ssd_scan"] += 1
        return ref.ssd_scan_plain(x, B, C, dt, A, D, chunk, final_state,
                                  state_out)

    def scan_bwd(x, B, C, dt, A, D, dy, chunk):
        sk.launches["ssd_scan_bwd"] += 1
        for p in sk.BWD_PASSES:
            sk.route_launches[p] += 1
        return ref.ssd_scan_bwd_plain(x, B, C, dt, A, D, dy, chunk)

    def rms(x, w, eps=1e-6):
        rk.launches["rmsnorm"] += 1
        return ref.rmsnorm_plain(x, w, eps)

    def rms_bwd(x, w, g, eps=1e-6):
        rk.launches["rmsnorm_bwd"] += 1
        return ref.rmsnorm_bwd_plain(x, w, g, eps)

    real = dispatch._plan
    card = ("rmsnorm", "flash_attention", "ssd_scan")
    monkeypatch.setattr(dispatch, "_plan", lambda kind, what, ts: (
        "cuda" if kind in card else real(kind, what, ts)))
    monkeypatch.setattr(sk, "ssd_scan", scan)
    monkeypatch.setattr(sk, "ssd_scan_bwd", scan_bwd)
    monkeypatch.setattr(rk, "rmsnorm", rms)
    monkeypatch.setattr(rk, "rmsnorm_bwd", rms_bwd)


def test_chip_smoke_ssd_bwd_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.ssd_bwd_phase`` on the CPU at small cases of both
    dtypes (a ragged L, one chunk), K6's backward a counted plain version:
    each gradient held norm-wise, bitwise on repeat, one launch of each
    pass a call, the planted fault failing; the timed case's record."""
    cs = _chip_smoke()
    _counted_kernels(monkeypatch)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "kernel_device_ms",
                        lambda torch, fn, reps, key: (fn(), 0.5)[1])
    monkeypatch.setattr(cs, "ssd_bwd_pass_ms", lambda torch, fn, reps: (
        fn(), {p: 0.125 for p in sk.BWD_PASSES})[1])
    cases = [(2, 40, 5, 8, 16, 16, "bfloat16"), (1, 20, 3, 8, 4, 8,
                                                 "float32"),
             (2, 12, 2, 4, 8, 16, "float32")]
    out = cs.ssd_bwd_phase(torch, torch.device("cpu"), cases, timed=(0,),
                           emulated=(1, 64, 3, 8, 16, 16),
                           pass_probe=(1, 40, 3, 8, 16, 16))
    rec = out["ssd_scan_bwd"]
    assert rec["ms"] == 1.0 and rec["device_ms"] == 0.5
    assert rec["pass_ms"] == {p: 0.125 for p in sk.BWD_PASSES}
    assert rec["bound_by"] in ("bytes", "operations") and rec["bound_ms"] > 0
    assert rec["library_ms"] is None and rec["rel"] <= cs.LM_REF_REL
    printed = capsys.readouterr().out
    assert printed.count("planted fault") == len(cases)
    assert "float32 route bwd_states 0.1250" in printed


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_1_2b"])
def test_chip_smoke_lm_train_phase_rehearses_the_ssm_families(
        arch, monkeypatch):
    """``chip_smoke.lm_train_phase`` on the Mamba2 and Zamba2 smoke widths
    (bf16 activations, full remat) with counted plain kernels under the
    card plan: K6 twice a layer a step (once recomputed) and its backward
    once, as ``expected_launches(mode="train")`` says; step 1 against the
    plain route with both planted faults (K7's dw × 2, K6's dB × 2)
    failing; K5 refused, K6 differentiating."""
    from repro_torch.configs import get_smoke_config
    cs = _chip_smoke()
    _counted_kernels(monkeypatch)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    cfg = get_smoke_config(arch).replace(act_dtype="bfloat16")
    want = cs.expected_launches(cfg, "train")
    assert want["ssd_scan"] == 2 * cfg.n_layers
    assert want["ssd_scan_bwd"] == cfg.n_layers
    torch.set_num_threads(1)
    out = cs.lm_train_phase(torch, np, torch.device("cpu"), cfg, batch=2,
                            seq=16, n_steps=2, profile=False)
    assert out["launches_per_step"] == want
    assert out["planted_fails"] and out["k6_grad"]
    assert set(out["full"]["faults"]) == {"dw x 2", "dB x 2"}
    assert len(out["refused"]) == 2 and np.isfinite(out["losses"]).all()


def test_chip_smoke_ssd_bwd_resources_holds_the_tensor_core_kernels():
    """``chip_smoke.ssd_bwd_resources`` passes a library whose bf16 states
    and chunk kernels (both load variants) contain HGMMA and spill nothing,
    and fails one that spills, one without HGMMA and one without the
    kernels; the mangled names of the library label as those kernels."""
    cs = _chip_smoke()
    ok = {"registers": 200, "spill_bytes": 0, "HGMMA": 9}
    good = {f"{k}<{v}>": dict(ok) for k in cs.SSD_BWD_TC_KERNELS
            for v in (0, 1)}
    good["ssd_bwd_chunk_kernel"] = {"registers": 254, "spill_bytes": 0,
                                    "HGMMA": 0}
    line = cs.ssd_bwd_resources(good)
    assert "ssd_bwd_tc_chunk_kernel<1> 200 registers, 0 spill bytes, " \
           "HGMMA 9" in line
    for bad in ({"spill_bytes": 24}, {"HGMMA": 0}):
        fault = {k: dict(v) for k, v in good.items()}
        fault["ssd_bwd_tc_chunk_kernel<1>"].update(bad)
        with pytest.raises(AssertionError):
            cs.ssd_bwd_resources(fault)
    with pytest.raises(AssertionError, match="no ssd_bwd_tc_states_kernel"):
        cs.ssd_bwd_resources({k: v for k, v in good.items()
                              if "states" not in k})
    sym = ("_ZN48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_c9db1c942tc23"
           "ssd_bwd_tc_chunk_kernelILb1EEEvNS_4ArgsE")
    assert cs.kernel_label(sym) == "ssd_bwd_tc_chunk_kernel<1>"
