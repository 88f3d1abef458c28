#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (``nvcc``); without a card, or run
from a directory that lacks ``src/repro_torch``, it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.

Phases, each raising on a failed check:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/kernels/csrc/*.cu`` (``edge_latency.cu``,
   ``flash_attention.cu``, ``ssd_scan.cu``, ``rmsnorm.cu``) compiled with
   ``nvcc`` for ``sm_90a``, all in parallel, ptxas register / spill lines;
2. kernels: each CUDA kernel against its plain PyTorch version computed in
   float64 on the card, ≤1e-5 relative (max |err| / max |want|), bitwise
   equal on a repeat launch — at the serving shapes, at V ∈ {7, 129, 300}
   × E ∈ {1, 33, 130, 0} × shared / per-scenario scenario batch (× R ∈
   {1, 8} for the structured kernel) and on all-negative operands; kernel,
   plain and library times at the serving shapes beside the roofline bound;
3. serve_dense: ``WhatIfService`` on a 12-operator DAG, dense fleets of
   V = 4096 devices, S = 4 scenarios; three tenants send score, rank and
   joint queries totalling 1024 rows (one full chunk);
4. serve_structured: the same DAG on a ``RegionFleetFamily`` of
   V = 131 072 devices in R = 8 regions, S = 4, 256 rows over three
   queries.

Each serving phase checks served scores bitwise against a direct
``score_grid`` with the same dq/β, eight (scenario, placement) pairs
against the float64 oracle (``repro_torch.core.costmodel``) at ≤1e-5, and
that its kernel launched; the structured phase also checks that two
``score_grid`` calls are bitwise equal.

2b. single_tile: K4a and K4b (the whole-V references) through their
   dispatch routes at tests/test_kernel_blocking.py's inputs (B 2, E 5,
   V 64, R 4), at E ∈ {1, 33} and at V ∈ {1, 37, 128, the largest V the
   kernel accepts}, shared and per-scenario: K4a bitwise equal to K1 and
   K4b to K2, both ≤1e-5 relative to the float64 plain version, bitwise
   on a repeat launch, and the size refusal above the largest V; kernel
   and plain times at V 64 and at the largest V;
3b. serve_multi_dense: the serve_dense instance registered with all five
   §3.1 objectives (``ObjectiveSet.of(*OBJECTIVES)``, unit weights) and
   per-scenario speeds; four queries (score; rank by ε-constraint,
   minimize latency_f with network_movement_cost capped at its median;
   pareto; joint) over the same three tenants, 1024 rows, one chunk;
4b. serve_multi_structured: the serve_structured family with the same set
   and queries, 256 rows.

Each multi-objective phase checks every served per-objective grid and
score bitwise against a direct ``score_grid(objectives=...)`` over the
rows as dispatched (the padded chunk), eight (scenario, placement) cells
of every objective against ``ObjectiveSet.scalar_values`` on that
scenario's fleet at ≤1e-5 relative (abs 1e-6), the pareto front and the
ε-rank against ``pareto_front`` / ``epsilon_constraint`` on the direct
grids, and that K1 (K2) launched S times in the one dispatch; the
structured phase checks that two ``score_grid(objectives=...)`` calls are
bitwise equal.

5. flash_attention: K5 against its plain version on the card — float32
   inputs against the float64 plain version at ≤1e-5 relative, bfloat16
   inputs against the plain version on the same inputs in float32 math at
   ≤1e-2 relative (one bfloat16 ulp of the largest output: both round a
   float32 result once) — causal and full, at the tests/test_kernels.py
   shapes, at ragged S ∈ {100, 1000} and at the serving shape (one
   lm_score shard: 11 rows × 2048 tokens × 16 heads of 128), bitwise equal
   on a repeat launch; K5, plain, ``scaled_dot_product_attention`` (timed
   as a yardstick only, never called by the port) and the roofline bound
   at the serving shape;
6. lm_score: the streaming job of ``examples/geo_placement.py`` (ingest →
   clean → dq_check → lm_score → window_mean; 12 devices in 3 regions,
   uniform placement) with OLMo-1B at its published widths
   (``attention_impl="pallas"``, seeded random weights made on the card)
   as the LM-scoring operator: two engine batches of 128 rows × 2048 tokens
   with 5 % dropout rows.  It checks that K5 launched 16 times (once per
   layer) in every lm_score shard call, that the scores are finite, that
   one shard's scores agree with the same forward with
   ``attention_impl="reference"`` within 1e-2 relative (bfloat16
   activations through 16 layers), and that ``rows_out`` is what the
   engine's counts predict; it prints per-batch wall time, tokens/s, peak
   memory and a ``torch.profiler`` breakdown of a third batch (K5, K6, K7,
   float32 and bf16 GEMMs, conv/elementwise kernels, copies, other, idle
   share);
7. ssm kernels: K6 (SSD chunked scan) and K7 (RMSNorm) against their plain
   versions on the card, with the bars of phase 5 — float32 inputs against
   the float64 plain version at ≤1e-5 (for K6, or the plain version's own
   float32 error on the same inputs where that is larger: its cumsum
   differences lose digits over a 256-row chunk), bfloat16 inputs at ≤1e-2
   against the plain version in float32 math — bitwise equal on a repeat
   launch.  K6 at the tests/test_kernels.py shapes, ragged L (in one chunk
   and over several chunks at P = 64, N = 128, chunk 256) and the serving
   shape of one lm_score shard (b 11, L 2048, H 64, P 64, N 128, chunk
   256; x, B, C read as strided views of one conv output, as the model
   passes them); K7 at vectorised, scalar and unaligned rows and at the
   serving shapes (22 528 rows × 2048, the block norm, and × 4096, the gate
   norm).  Kernel, plain and bound times at the serving shapes, and
   ``torch.nn.functional.rms_norm`` for K7 (timed as a yardstick only,
   never called by the port; there is no single PyTorch call for the scan);
8. lm_score_mamba2: the job of phase 6 with Mamba2-1.3B at its published
   widths (48 layers, d 2048, d_inner 4096, 64 SSM heads of 64, state 128,
   chunk 256, vocab 50432 padded; seeded random weights made on the card)
   after the OLMo model is freed.  It checks that K6 launched 48 times and
   K7 97 times (2 per layer + the final norm) in every shard call, finite
   scores, one shard's scores against the same forward with K6/K7 swapped
   for their plain versions (inside the check only) within 1e-2, and the
   row counts; it prints what phase 6 prints.

The launch counts are set to 0 just before a phase drives its main path
(the service, the engine) and read just after it.  The last lines are the
card, one JSON object listing every ported kernel and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
REL = 1e-5
SEED = 0
# NVIDIA H100 SXM data sheet at its full 700 W limit: FP32 on the CUDA
# cores (the kernels use no tensor cores) and HBM3 bandwidth
PEAK_FP32 = 67e12
HBM_BW = 3.35e12

N_OPS, EDGE_PROB = 12, 0.3
S = 4
DENSE_V, DENSE_ROWS = 4096, (512, 256, 256)          # one 1024-row chunk
STRUCT_V, STRUCT_R, STRUCT_ROWS = 131_072, 8, (128, 64, 64)
# the multi-objective phases: four queries over the same three tenants
MULTI_TENANTS = ("a", "b", "c", "a")
MULTI_DENSE_ROWS = (384, 256, 256, 128)              # one 1024-row chunk
MULTI_STRUCT_ROWS = (96, 64, 64, 32)
# K4a / K4b: test_kernel_blocking.py's inputs (B 2, E 5, V 64, R 4)
TILE_B, TILE_E, TILE_V, TILE_R = 2, 5, 64, 4
TILE_ES, TILE_VS = (1, 33), (1, 37, 128)       # + the largest V accepted
TILE_TIMED = (4, 1024)          # (B, E) of the timed calls: 4096 edge rows
SOURCES = {"edge_latency_dense": "src/repro_torch/kernels/csrc/edge_latency.cu",
           "edge_latency_structured":
               "src/repro_torch/kernels/csrc/edge_latency.cu",
           "edge_latency_dense_single_tile":
               "src/repro_torch/kernels/csrc/edge_latency.cu",
           "edge_latency_structured_single_tile":
               "src/repro_torch/kernels/csrc/edge_latency.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu"}
REPLACES = {"edge_latency_dense": "src/repro/kernels/edge_latency.py:160",
            "edge_latency_structured": "src/repro/kernels/edge_latency.py:246",
            "edge_latency_dense_single_tile":
                "src/repro/kernels/edge_latency.py:311",
            "edge_latency_structured_single_tile":
                "src/repro/kernels/edge_latency.py:357",
            "flash_attention": "src/repro/kernels/flash_attention.py:76",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:70",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:30"}
# K5 cases: the tests/test_kernels.py shapes and ragged S, (B, S, H, D)
ATTN_SHAPES = [(1, 128, 1, 64), (2, 128, 4, 64), (1, 256, 2, 128),
               (2, 96, 3, 32), (1, 384, 2, 64), (1, 100, 2, 64),
               (1, 1000, 2, 128)]
BF16_REL = 1e-2      # one bfloat16 ulp of the largest output
# lm_score: OLMo-1B's context length (arXiv:2402.00838) per row
LM_ARCH, LM_ROWS, LM_SEQ, LM_BATCHES, LM_DROPOUT = "olmo_1b", 128, 2048, 2, 0.05
# one shard's scores, kernels vs the plain route (chunked attention; K6/K7's
# plain versions), bf16 activations through 16 (OLMo) or 48 (Mamba2) layers
LM_REF_REL = 1e-2
SSM_ARCH = "mamba2_1_3b"
# K6 cases (b, L, H, P, N, chunk): the tests/test_kernels.py shapes, a
# ragged L in one chunk, and ragged multi-chunk L at the model's P, N, chunk
SSD_CASES = [(2, 64, 8, 16, 16, 16), (1, 128, 4, 32, 8, 16),
             (2, 32, 2, 8, 4, 16), (1, 20, 5, 8, 16, 8),
             (2, 300, 6, 64, 128, 256), (1, 700, 3, 64, 128, 256)]
# K7 cases (rows, D, offset): vectorised and scalar rows (D % 8 != 0 for
# bf16, D = 37), and an offset of one element (rows not 16-byte aligned)
RMS_CASES = [(1, 64, 0), (3, 100, 0), (7, 2048, 0), (5, 128, 0),
             (33, 4096, 0), (9, 37, 0), (4, 256, 1)]
# profiler groups: float32 GEMMs (the dt projection and the head) first
F32_GEMM = ("f32f32", "sgemm", "nvjet_sss", "nvjet_tss")
GEMM = ("gemm", "cutlass", "xmma", "cublas", "nvjet")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want| / max |want|, max |got − want|) in float64."""
    got, want = got.double(), want.double()
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err / max(float(want.abs().max()), 1e-30), err


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(torch, fn) -> tuple[float, dict[str, list]]:
    """One call of ``fn`` under ``torch.profiler``: its wall ms and, per
    device kernel or copy name, [summed ms, count]."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    return wall_ms, per_name


def device_profile(torch, fn, groups: dict | None = None) -> str:
    """Wall time of one profiled call of ``fn``, the summed device time of
    its kernels and copies (one stream, so the sum is the busy time), the
    idle share, the device time of each group of ``groups`` (name →
    substrings of kernel names; the first group that matches takes a
    kernel, the rest is "other") and the largest device consumers."""
    wall_ms, per_name = device_events(torch, fn)
    if not per_name:
        return f"wall {wall_ms:.1f} ms; the profiler recorded no device events"
    busy = sum(v[0] for v in per_name.values())
    text = (f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle "
            f"{max(0.0, 1 - busy / wall_ms):.1%}")
    if groups:
        sums = {g: [0.0, 0] for g in (*groups, "other")}
        for name, (t, c) in per_name.items():
            g = next((g for g, keys in groups.items()
                      if any(k in name.lower() for k in keys)), "other")
            sums[g][0] += t
            sums[g][1] += c
        text += "; " + ", ".join(f"{g} {t:.1f} ms x{c}"
                                 for g, (t, c) in sums.items())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    return text + "; top: " + "; ".join(
        f"{n[:48]} {t:.2f} ms x{c}" for n, (t, c) in top)


def placements(torch, gen, rows: int, n_ops: int, V: int, density: float):
    """(rows, n_ops, V) float32 host placements made on the card: each
    operator on a random ~``density`` share of the devices with
    exponential (Dirichlet(1)) weights, rows summing to 1."""
    u = torch.rand((rows, n_ops, V), generator=gen, device=DEVICE)
    w = torch.rand((rows, n_ops, V), generator=gen, device=DEVICE)
    w = -torch.log1p(-w) * (u < density)
    first = torch.randint(0, V, (rows, n_ops, 1), generator=gen,
                          device=DEVICE)
    w.scatter_(-1, first, 1.0)                  # never an empty row
    return (w / w.sum(-1, keepdim=True)).cpu().numpy()


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def attention_phase(torch, dev, serving: tuple) -> dict:
    """K5 against its plain version at every case shape and at ``serving``
    (B, S, H, D); its times there.  Returns the kernel line's numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.perf.roofline import flash_attention_terms

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def operands(shape, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    def hold(q, k, v, causal, what):
        out = fa.flash_attention(q, k, v, causal=causal)
        again = fa.flash_attention(q, k, v, causal=causal)
        if q.dtype == torch.float32:
            want = ref.flash_attention_plain(q.double(), k.double(),
                                             v.double(), causal=causal)
            bar = REL
        else:
            want = ref.flash_attention_plain(q, k, v, causal=causal)
            bar = BF16_REL
        sync(torch, dev)
        rel, err = rel_err(out, want)
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"flash_attention {what}: {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out).all()),
              f"flash_attention {what}: non-finite output")
        check(rel <= bar, f"flash_attention {what}: rel err {rel:.3e} > {bar}")
        check(torch.equal(out, again),
              f"flash_attention {what}: repeat launch differs")
        return rel, err

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for shape in ATTN_SHAPES:
        for dtype in worst:
            for causal in (True, False):
                rel, _ = hold(*operands(shape, dtype), causal,
                              f"{shape} {dtype} causal={causal}")
                worst[dtype] = max(worst[dtype], rel)
                cases += 1
    q, k, v = operands(serving, torch.float32)
    rel32, _ = hold(q, k, v, True, f"serving {serving} float32")
    del q, k, v
    q, k, v = operands(serving, torch.bfloat16)
    rel, err = hold(q, k, v, True, f"serving {serving} bfloat16")
    print(f"flash_attention: {cases} case shapes plus the serving shape "
          f"within bounds and bitwise on repeat; worst rel err float32 "
          f"{max(worst[torch.float32], rel32):.3e} (bar {REL}), bfloat16 "
          f"{max(worst[torch.bfloat16], rel):.3e} (bar {BF16_REL})")
    # SDPA takes (B, H, S, D): its operands are laid out for it up front
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    terms = flash_attention_terms(*serving, torch.bfloat16, causal=True)
    r = {"max_abs_err": err, "rel_err": rel,
         "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10),
         "plain_ms": time_ms(
             lambda: ref.flash_attention_plain(q, k, v, causal=True), 5),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True), 10),
         "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
         "flops": terms.flops, "bytes": terms.bytes,
         "shape": "B={} S={} H={} D={} bf16 causal".format(*serving)}
    print(f"kernel flash_attention [{r['shape']}]: {r['ms']:.3f} ms "
          f"({terms.flops / r['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}; "
          f"{r['bound_ms'] / r['ms']:.1%} of it)")
    return r


def ssd_operands(torch, gen, dev, b, L, H, P, N, dtype, model_like=False):
    """x (b, L, H, P) and B, C (b, L, N) in ``dtype``, dt (b, L, H), A, D
    (H,) float32.  Case inputs follow tests/test_kernels.py (dt =
    softplus(z)/2, A = −exp(0.3 z)); ``model_like`` ones follow the Mamba2
    forward (dt = softplus(z − 2), A = −linspace(1, 16, H)) and are read as
    views of one (b, L, H·P + 2N) tensor, the conv output the model
    slices them from."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if model_like:
        conv = randn(b, L, H * P + 2 * N).to(dtype)
        x = conv[..., :H * P].reshape(b, L, H, P)
        B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
        dt = F.softplus(randn(b, L, H) - 2.0)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        x = randn(b, L, H, P).to(dtype)
        B, C = (randn(b, L, N) * 0.5).to(dtype), (randn(b, L, N) * 0.5).to(dtype)
        dt = F.softplus(randn(b, L, H)) * 0.5
        A = -torch.exp(randn(H) * 0.3)
    return x, B, C, dt, A, randn(H)


def ssm_kernels_phase(torch, dev, shard_rows: int, seq: int, cfg) -> dict:
    """K6 and K7 against their plain versions at the case shapes, a ragged
    L and the serving shapes of one lm_score shard of ``cfg`` (Mamba2),
    bitwise on repeat; their times there.  Returns the kernel line's
    numbers for both."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.perf.roofline import rmsnorm_terms, ssd_scan_terms

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = {}

    def hold(name, kernel, plain, args, widen, what):
        """``widen``: the f32 bar becomes the plain version's own float32
        error against float64 on these inputs where that is larger."""
        out, again = kernel(*args), kernel(*args)
        f32 = args[0].dtype == torch.float32
        if f32:
            want = plain(*(a.double() if torch.is_tensor(a) else a
                           for a in args))
            bar = REL
            if widen:
                own, _ = rel_err(plain(*args), want)
                bar = max(REL, own)
        else:
            want, bar = plain(*args), BF16_REL
        sync(torch, dev)
        rel, err = rel_err(out, want)
        check(out.shape == args[0].shape and out.dtype == args[0].dtype,
              f"{name} {what}: {out.shape} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name} {what}: non-finite")
        check(rel <= bar, f"{name} {what}: rel err {rel:.3e} > {bar:.3e}")
        check(torch.equal(out, again), f"{name} {what}: repeat launch differs")
        key = (name, "float32" if f32 else "bfloat16")
        worst[key] = max(worst.get(key, 0.0), rel)
        return rel, err, bar

    cases = 0
    for b, L, H, P, N, Q in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = (*ssd_operands(torch, gen, dev, b, L, H, P, N, dtype), Q)
            hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args, True,
                 f"(b={b} L={L} H={H} P={P} N={N} Q={Q}) {dtype}")
            cases += 1
    for rows, D, offset in RMS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(rows * D + offset, generator=gen,
                               device=dev).to(dtype)
            x = flat[offset:].view(rows, D)     # offset 1: unaligned rows
            w = torch.randn(D, generator=gen, device=dev)
            hold("rmsnorm", rk.rmsnorm, ref.rmsnorm_plain, (x, w), False,
                 f"({rows}, {D}) offset {offset} {dtype}")
            cases += 1

    out = {}
    # K6 at the serving shape: one shard's SSD, as the model calls it
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    serving = (shard_rows, seq, H, P, N)
    args = (*ssd_operands(torch, gen, dev, *serving, torch.float32,
                          model_like=True), Q)
    rel32, _, bar32 = hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args,
                           True, f"serving {serving} float32")
    del args
    args = (*ssd_operands(torch, gen, dev, *serving, torch.bfloat16,
                          model_like=True), Q)
    rel, err, _ = hold("ssd_scan", sk.ssd_scan, ref.ssd_scan_plain, args,
                       False, f"serving {serving} bfloat16")
    terms = ssd_scan_terms(*serving, Q, torch.bfloat16)
    out["ssd_scan"] = {
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda: sk.ssd_scan(*args), 5),
        "plain_ms": time_ms(lambda: ref.ssd_scan_plain(*args), 3),
        "library_ms": None, "bound_ms": terms.step_time_s * 1e3,
        "bound_by": terms.bound_by, "flops": terms.flops,
        "bytes": terms.bytes,
        "shape": "b={} L={} H={} P={} N={} Q={} bf16 x/B/C (views of one "
                 "conv output), f32 dt".format(*serving, Q)}
    print(f"ssd_scan serving float32: rel err {rel32:.3e} against float64, "
          f"bar {bar32:.3e} (1e-5, or the plain float32 version's own error "
          f"on the same inputs where larger)")
    del args
    # K7 at the serving shapes: the block norm (d) and the gate norm (d_inner)
    times = {}
    for D, what in ((cfg.d_model, "block"), (cfg.d_inner, "gate")):
        rows = shard_rows * seq
        x = torch.randn((rows, D), generator=gen, device=dev)
        w = torch.randn(D, generator=gen, device=dev)
        hold("rmsnorm", rk.rmsnorm, ref.rmsnorm_plain, (x, w), False,
             f"serving ({rows}, {D}) float32")
        x = x.bfloat16()
        rel, err, _ = hold("rmsnorm", rk.rmsnorm, ref.rmsnorm_plain, (x, w),
                           False, f"serving ({rows}, {D}) bfloat16")
        # yardsticks only, never called by the port: rms_norm on the same
        # inputs (float32 w), and with a bf16 w, which may take a fused path
        wb = w.bfloat16()
        try:
            F.rms_norm(x, (D,), weight=w, eps=1e-6)
            wl, lib_w = w, "float32 w"
        except RuntimeError:
            wl, lib_w = wb, "bfloat16 w (refuses float32 w)"
        terms = rmsnorm_terms(rows, D, torch.bfloat16)
        times[what] = {
            "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(lambda: rk.rmsnorm(x, w), 20),
            "plain_ms": time_ms(lambda: ref.rmsnorm_plain(x, w), 10),
            "library_ms": time_ms(lambda: F.rms_norm(
                x, (D,), weight=wl, eps=1e-6), 20),
            "library": f"torch.nn.functional.rms_norm, {lib_w}; with a "
                       f"bfloat16 w " + "{:.3f} ms".format(time_ms(
                           lambda: F.rms_norm(x, (D,), weight=wb, eps=1e-6),
                           20)),
            "bound_ms": terms.step_time_s * 1e3, "bound_by": terms.bound_by,
            "flops": terms.flops, "bytes": terms.bytes,
            "shape": f"rows={rows} D={D} bf16 ({what} norm)"}
        del x, w, wb, wl
    out["rmsnorm"] = times["block"]
    out["rmsnorm_gate"] = times["gate"]
    print(f"ssm kernels: {cases} case shapes plus the serving shapes within "
          f"bounds and bitwise on repeat; worst rel err " + ", ".join(
              f"{k} {d} {v:.3e}" for (k, d), v in sorted(worst.items())))
    for k, r in out.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.3f} ({r['library']})"
        print(f"kernel {k} [{r['shape']}]: {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.1%} of it), rel err "
              f"{r['rel_err']:.3e}")
    return out


def single_tile_phase(torch, dev) -> dict:
    """K4a/K4b through their dispatch routes at every case shape (the
    phase's main path, launches counted from 0), then held against K1/K2
    bitwise, against the float64 plain version at ≤1e-5 and against a
    repeat launch; the size refusal; times at V 64 and at the largest V.
    Returns each kernel's line numbers and the launches."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.perf.roofline import (
        edge_latency_single_tile_terms,
        edge_latency_structured_single_tile_terms)

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    names = {"dense": "edge_latency_dense_single_tile",
             "structured": "edge_latency_structured_single_tile"}
    route = {"dense": dispatch.edge_latency_single_tile,
             "structured": dispatch.edge_latency_structured_single_tile}
    blocked = {"dense": kernels.edge_latency_dense,
               "structured": kernels.edge_latency_structured}
    single = {"dense": kernels.edge_latency_dense_single_tile,
              "structured": kernels.edge_latency_structured_single_tile}
    plain = {"dense": ref.edge_latency_dense_single_tile_plain,
             "structured": ref.edge_latency_structured_single_tile_plain}
    vmax = {"dense": kernels.single_tile_max_v(),
            "structured": kernels.single_tile_max_v(TILE_R)}

    def operands(kind, B, E, V, shared):
        bc = 1 if shared else B
        if kind == "dense":
            return randn(B, E, V), randn(B, E, V), randn(bc, V, V)
        return (randn(B, E, V), randn(B, E, V), randn(B, E, TILE_R),
                randn(bc, TILE_R, V), randn(bc, 1, V))

    cases = []
    for kind in ("dense", "structured"):
        shapes = [(TILE_E, TILE_V)] + [(E, TILE_V) for E in TILE_ES] \
            + [(TILE_E, V) for V in (*TILE_VS, vmax[kind])]
        for shared in (True, False):
            for E, V in shapes:
                what = (f"B={TILE_B} E={E} V={V}"
                        + ("" if kind == "dense" else f" R={TILE_R}")
                        + f" shared={shared}")
                cases.append((kind, what,
                              operands(kind, TILE_B, E, V, shared)))
    sync(torch, dev)
    kernels.reset_launches()
    outs = [route[kind](*args) for kind, _, args in cases]
    sync(torch, dev)
    launched = {names[k]: kernels.launches[names[k]] for k in names}
    for kind, name in names.items():
        n = sum(1 for k, _, _ in cases if k == kind)
        check(launched[name] == n,
              f"single_tile: {name} launched {launched[name]} times for "
              f"{n} cases")
    worst = {name: 0.0 for name in names.values()}
    for (kind, what, args), out in zip(cases, outs):
        name = names[kind]
        check(torch.equal(out, blocked[kind](*args)),
              f"{name} {what}: differs from the blocked kernel")
        check(torch.equal(out, single[kind](*args)),
              f"{name} {what}: repeat launch differs")
        rel, _ = rel_err(out, plain[kind](*(a.double() for a in args)))
        check(rel <= REL, f"{name} {what}: rel err {rel:.3e} > {REL}")
        worst[name] = max(worst[name], rel)
    for kind, name in names.items():
        V = vmax[kind] + 1
        try:
            single[kind](*operands(kind, 1, 1, V, True))
        except ValueError as e:
            check("shared memory" in str(e), f"{name}: refusal says {e}")
        else:
            raise AssertionError(f"{name} accepted V={V} over its limit")
    print(f"single_tile: {len(cases)} cases through the dispatch routes, "
          f"launches {launched}; K4a == K1 and K4b == K2 bitwise, repeats "
          f"bitwise, worst rel err to float64 " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f"; largest V accepted: K4a {vmax['dense']}, K4b "
            f"{vmax['structured']} (R={TILE_R}); V+1 refused")

    report = {}
    B, E = TILE_TIMED
    for kind, name in names.items():
        for V in (TILE_V, vmax[kind]):
            args = operands(kind, B, E, V, True)
            out = single[kind](*args)
            rel, err = rel_err(out, plain[kind](*(a.double() for a in args)))
            check(rel <= REL, f"{name} timed B={B} E={E} V={V}: rel err "
                              f"{rel:.3e} > {REL}")
            if kind == "dense":
                terms = edge_latency_single_tile_terms(B, E, V, 1)
                xi, xj, com = args
                lib = time_ms(lambda: (xi * torch.einsum(
                    "buv,bev->beu", com, xj)).amax(-1), 10)
            else:
                terms = edge_latency_structured_single_tile_terms(
                    B, E, V, TILE_R, 1)
                lib = None
            r = {"max_abs_err": err, "rel_err": rel,
                 "ms": time_ms(lambda: single[kind](*args), 20),
                 "blocked_ms": time_ms(lambda: blocked[kind](*args), 20),
                 "plain_ms": time_ms(lambda: plain[kind](*args), 10),
                 "library_ms": lib, "bound_ms": terms.step_time_s * 1e3,
                 "bound_by": terms.bound_by,
                 "shape": f"B={B} E={E} V={V}"
                          + ("" if kind == "dense" else f" R={TILE_R}")
                          + " shared"}
            lib_s = "n/a" if lib is None else f"{lib:.4f}"
            print(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, blocked "
                  f"{r['blocked_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {lib_s} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)")
            report[name] = r          # the largest V's numbers stay
    return {"report": report, "launches": launched}


def serve_multi_phase(torch, np, dev, phase: str, graph, pack, xs,
                      rows: tuple, speed, kernel: str, oracle_fleet,
                      profile: bool = True) -> dict:
    """``WhatIfService`` with all five §3.1 objectives on ``pack`` (see
    the module docstring, phases 3b/4b): four queries from three tenants
    in one chunk, launches counted from 0 around submit → drain, every
    served grid and score against a direct ``score_grid(objectives=)``
    over the padded chunk, the oracle, the decision layer.  Returns the
    launches, peak memory, the oracle's worst error, and the padded chunk,
    evaluator and set for a caller's further checks."""
    from repro_torch.core.objectives import (OBJECTIVES, ObjectiveGrids,
                                             ObjectiveSet)
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search.decision import (candidate_values,
                                             epsilon_constraint,
                                             joint_dq_scores, pareto_front,
                                             split_dq_term)
    from repro_torch.serve import (AdmissionConfig, QueryResult, WhatIfQuery,
                                   WhatIfService)
    from repro_torch.serve.bucketing import (dq_denominator, finish_scores,
                                             next_pow2, pad_rows)
    from repro_torch.sim import BatchedEvaluator

    obj = ObjectiveSet.of(*OBJECTIVES)
    svc = WhatIfService(graph, device=dev,
                        admission=AdmissionConfig(p99_budget_s=1e6))
    fids = {svc.register_fleet(t, pack, objectives=obj, speed=speed)
            for t in set(MULTI_TENANTS)}
    check(len(fids) == 1, f"{phase}: equal packs got different ids")
    (fid,) = fids
    n = sum(rows)
    check(n <= svc.max_chunk_rows, f"{phase}: {n} rows are not one chunk")
    cuts = np.cumsum((0,) + rows)
    sl = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(len(rows))]
    padded = pad_rows(xs[:n], next_pow2(n))           # the rows as dispatched
    ev = BatchedEvaluator.shared(graph, device=dev)
    direct = ev.score_grid(padded, pack, objectives=obj,
                           speed=speed).to_host()
    S = direct.scalarized.shape[0]

    def raw_of(i):
        return ObjectiveGrids(names=obj.names,
                              grids={k: g[:, sl[i]]
                                     for k, g in direct.grids.items()},
                              scalarized=direct.scalarized[:, sl[i]],
                              weights=obj.weights)

    cap = float(np.median(candidate_values(raw_of(1))[
        :, obj.names.index("network_movement_cost")]))
    dqv = np.linspace(0.0, 1.0, 5)
    queries = [
        WhatIfQuery(kind="score", placements=xs[sl[0]], dq=0.3, beta=0.7),
        WhatIfQuery(kind="rank", placements=xs[sl[1]],
                    dq=np.linspace(0.1, 0.8, S), beta=1.3, top_k=5,
                    minimize="latency_f",
                    eps_caps={"network_movement_cost": cap}),
        WhatIfQuery(kind="pareto", placements=xs[sl[2]]),
        WhatIfQuery(kind="joint", placements=xs[sl[3]], dq_values=dqv,
                    beta=0.5),
    ]
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [svc.submit(t, fid, q) for t, q in zip(MULTI_TENANTS, queries)]
    completed = svc.drain()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    buckets = svc.stats.snapshot()["buckets"]
    n_disp = sum(b["dispatches"] for b in buckets)
    check(completed == len(queries),
          f"{phase}: {completed} queries completed")
    check(n_disp == 1, f"{phase}: {n_disp} dispatches for one chunk")
    check(launched[kernel] == S * n_disp,
          f"{phase}: {kernel} launched {launched[kernel]} times, want "
          f"{S} per dispatch")
    mail = {t: svc.poll(t) for t in set(MULTI_TENANTS)}
    results = []
    for t, tk in zip(MULTI_TENANTS, tickets):
        (res,) = [m for m in mail[t] if isinstance(m, QueryResult)
                  and m.query_id == tk.query_id]
        results.append(res)

    for i, (q, res) in enumerate(zip(queries, results)):
        raw = raw_of(i)
        lat, rest, w_lat = split_dq_term(raw)
        lat = np.asarray(lat, dtype=np.float32)
        rest = np.asarray(rest, dtype=np.float32)
        what = f"{phase} {q.kind}"
        if q.kind == "joint":
            want, want_idx = joint_dq_scores(lat, dqv, q.beta, rest=rest,
                                             w_lat=w_lat)
            check(np.array_equal(res.scores, want)
                  and np.array_equal(res.dq_idx, want_idx),
                  f"{what}: scores or dq choice differ from the direct grid")
            finished = raw.grids
        else:
            check(np.array_equal(res.scores, finish_scores(
                lat, rest, w_lat, q.dq, q.beta)),
                f"{what}: scores differ from the direct grid's")
            denom = dq_denominator(q.dq, q.beta, S)
            finished = {k: g / denom if k == "latency_f" else g
                        for k, g in raw.grids.items()}
        for k in obj.names:
            check(np.array_equal(res.grids[k], finished[k]),
                  f"{what}: served {k} grid differs from the direct one")
        og = ObjectiveGrids(names=obj.names, grids=finished,
                            scalarized=res.scores, weights=obj.weights)
        if q.kind == "pareto":
            front = pareto_front(og)
            check(np.array_equal(res.front.indices, front.indices)
                  and np.array_equal(res.front.values, front.values),
                  f"{what}: front differs from pareto_front")
        if q.kind == "rank":
            best, masked = epsilon_constraint(og, q.minimize, q.eps_caps)
            check(res.best == best and np.array_equal(res.worst, masked)
                  and np.array_equal(res.top, np.argsort(
                      masked, kind="stable")[:q.top_k])
                  and not res.infeasible,
                  f"{what}: ε-rank differs from epsilon_constraint")
    # the device's own dq/β finish of latency_f equals the host's
    q = queries[0]
    on_card = ev.score_grid(padded, pack, dq=q.dq, beta=q.beta,
                            objectives=obj, speed=speed).to_host()
    check(np.array_equal(results[0].grids["latency_f"],
                         on_card.grids["latency_f"][:, sl[0]]),
          f"{phase}: host and device dq/β finish of latency_f differ")
    # float64 oracle: every objective on eight cells of the score query
    worst_oracle = 0.0
    rng = np.random.default_rng(SEED + 4)
    for k in range(8):
        s, p = k % S, int(rng.integers(0, rows[0]))
        want = obj.scalar_values(graph, oracle_fleet(s),
                                 xs[sl[0]][p].astype(np.float64),
                                 dq=q.dq, beta=q.beta)
        for name, v in want.items():
            got = float(results[0].grids[name][s, p])
            err = abs(got - v)
            check(err <= max(REL * abs(v), 1e-6),
                  f"{phase}: oracle {name} ({s}, {p}) {got} vs {v}")
            worst_oracle = max(worst_oracle, err / max(abs(v), 1e-30))
    cells = S * n
    ms = [b["p50"] * 1e3 for b in buckets]
    mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
    print(f"{phase}: {completed} queries ({', '.join(q.kind for q in queries)}"
          f"), {n} rows x {S} scenarios x {len(obj.names)} objectives in "
          f"{n_disp} dispatch; {completed / wall:.2f} queries/s, "
          f"{cells / wall:.0f} cells/s, wall {wall * 1e3:.1f} ms, "
          f"ms/dispatch {', '.join(f'{m:.1f}' for m in ms)}; peak memory "
          f"{mem}; launches {launched}; served grids and scores == direct "
          f"bitwise; front, ε-rank, joint == decision layer; oracle worst "
          f"rel err {worst_oracle:.3e}; ε cap network_movement_cost "
          f"{cap:.6g}, front of {len(results[2].front)}")
    if profile:
        groups = {"K1": ("edge_latency_dense",),
                  "K2": ("edge_latency_structured",),
                  "movement SGEMM": GEMM + ("sgemm", "gemv"),
                  "elementwise": ("elementwise", "vectorized", "unrolled",
                                  "reduce", "cat", "index", "gather",
                                  "scatter"),
                  "copies": ("memcpy", "memset")}
        prof = device_profile(torch, lambda: (
            [svc.submit(t, fid, q) for t, q in zip(MULTI_TENANTS, queries)],
            svc.drain()), groups)
        print(f"{phase} profile (a second, profiled round): {prof}")
    return {"launches": launched, "peak": peak, "oracle_rel": worst_oracle,
            "padded": padded, "ev": ev, "obj": obj}


def example_fleet(np, ExplicitFleet):
    """examples/geo_placement.py's fleet: 3 regions × 4 devices, WAN costs
    between regions, region 0 twice as fast."""
    rng = np.random.default_rng(0)
    n_dev, n_regions = 12, 3
    region = np.repeat(np.arange(n_regions), n_dev // n_regions)
    wan = np.array([[0.02, 1.5, 2.5], [1.5, 0.02, 1.0], [2.5, 1.0, 0.02]])
    com = wan[np.ix_(region, region)] + rng.uniform(0, 0.05, (n_dev, n_dev))
    com = (com + com.T) / 2
    np.fill_diagonal(com, 0.0)
    speed = np.where(region == 0, 2.0, 1.0)
    return ExplicitFleet(com_cost=com, speed=speed, region=region), speed


def expected_launches(cfg) -> dict[str, int]:
    """Launches of each LM kernel in one forward of ``cfg`` (one lm_score
    shard call): K5 once per layer on the "pallas" attention route; K6 once
    per Mamba2 layer; K7 for every RMSNorm with a weight (block and final
    norms, qk-norms, Mamba2's gate norms)."""
    L, rms = cfg.n_layers, cfg.norm_type == "rmsnorm"
    if cfg.family == "ssm":
        return {"ssd_scan": L, "rmsnorm": (2 * L + 1) if rms else L}
    return {"flash_attention": L if cfg.attention_impl == "pallas" else 0,
            "rmsnorm": ((2 * L + 1) if rms else 0)
            + (2 * L if cfg.qk_norm else 0)}


def lm_launches() -> dict[str, int]:
    """The LM kernels' launch counts, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    return {**fa.launches, **sk.launches, **rk.launches}


def reset_lm_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    for mod in (fa, sk, rk):
        mod.reset_launches()


@contextlib.contextmanager
def plain_ssm_kernels():
    """K6 and K7 swapped for their plain versions (uncounted) inside the
    block, restored after it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    saved = sk.ssd_scan, rk.rmsnorm
    sk.ssd_scan, rk.rmsnorm = ref.ssd_scan_plain, ref.rmsnorm_plain
    try:
        yield
    finally:
        sk.ssd_scan, rk.rmsnorm = saved


def lm_score_phase(torch, np, dev, cfg, rows: int, seq: int, batches: int,
                   profile: bool = True) -> dict:
    """The example's streaming job with ``cfg`` as the LM-scoring operator
    (see the module docstring, phases 6 and 8).  Returns the launches of
    the family's main kernel (K5, or K6 for Mamba2) and of every LM kernel
    on the main path, and the phase's numbers."""
    from repro_torch.core.devices import ExplicitFleet
    from repro_torch.core.placement import uniform_placement
    from repro_torch.models import build_model
    from repro_torch.streaming import (StreamGraph, StreamingEngine, map_op,
                                       model_op, quality_op, quality_scores,
                                       source, window_agg)

    ssm = cfg.family == "ssm"
    phase = "lm_score_mamba2" if ssm else "lm_score"
    main_kernel = "ssd_scan" if ssm else "flash_attention"
    want_per_call = expected_launches(cfg)
    fleet, speed = example_fleet(np, ExplicitFleet)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    lm = model_op("lm_score", model, work=50.0)
    score_fn = lm.fn
    shards = []          # (rows, scores, LM kernel launches) per shard call

    def counted(shard_rows):
        before = lm_launches()
        out = score_fn(shard_rows)
        after = lm_launches()
        shards.append((shard_rows, out,
                       {k: after[k] - before[k] for k in want_per_call}))
        return out

    lm.fn = counted
    vocab = cfg.vocab
    ops = [source("ingest"),
           map_op("clean", lambda r: np.clip(r, 0, vocab - 1), work=0.5),
           quality_op("dq_check", threshold=0.4, work=2.0),
           lm,
           window_agg("window_mean", window=8, work=0.5)]
    g = StreamGraph(ops, [(0, 1), (1, 2), (2, 3), (3, 4)])
    x = uniform_placement(g.meta.n_ops, fleet.availability(g.meta.n_ops))
    eng = StreamingEngine(g, fleet, x, alpha=0.002, device_speed=speed)
    rng = np.random.default_rng(SEED)
    data = []
    for _ in range(batches + profile):
        batch = rng.integers(0, vocab, (rows, seq)).astype(float)
        batch[rng.random(rows) < LM_DROPOUT] = -1     # sensor dropouts
        data.append(batch)

    sync(torch, dev)
    reset_lm_launches()
    reports, walls, peaks = [], [], []
    for batch in data[:batches]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        reports.append(eng.run_batch(batch))
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else None)
    launched = {k: lm_launches()[k] for k in want_per_call}

    calls = len(shards)
    check(calls > 0, f"{phase}: the scoring operator never ran")
    for k, n in want_per_call.items():
        got = sorted({c[k] for _, _, c in shards})
        check(got == [n], f"{phase}: {k} launches per shard call {got}, "
                          f"want {n}")
        check(launched[k] == n * calls,
              f"{phase}: {launched[k]} {k} launches for {calls} shard calls")
    check(launched[main_kernel] > 0, f"{phase}: {main_kernel} never launched")
    for _, out, _ in shards:
        check(out.dtype == np.float32 and out.ndim == 2 and out.shape[1] == 1
              and bool(np.isfinite(out).all()),
              f"{phase}: scores not finite float32 (n, 1)")
    lm_ix = [op.name for op in g.ops].index("lm_score")
    for batch, rep in zip(data, reports):
        clean = np.clip(batch, 0, vocab - 1)
        n_scored = int((quality_scores(clean.astype(np.int64)) >= 0.4).sum())
        want_out = sum(len(r) // 8 for r in eng._split_rows(
            np.arange(n_scored), eng.x[lm_ix + 1]).values())
        check(int(rep.op_rows_in[lm_ix]) == n_scored
              and rep.rows_out == {"window_mean": want_out},
              f"{phase}: rows {rep.op_rows_in.tolist()} -> {rep.rows_out}, "
              f"want {n_scored} scored -> {want_out}")

    # one shard against the same forward through the plain route: the
    # chunked reference attention (dense) or K6/K7's plain versions (ssm)
    shard_rows, got, _ = shards[0]
    if ssm:
        what = "K6/K7 vs their plain versions"
        with plain_ssm_kernels():
            want = model_op("reference", model).fn(shard_rows)
    else:
        what = "flash vs reference attention"
        ref_model = build_model(cfg.replace(attention_impl="reference"),
                                device=dev)
        ref_model.load_state_dict(model.state_dict())
        want = model_op("reference", ref_model).fn(shard_rows)
        del ref_model
    ref_rel = float(np.abs(got.astype(np.float64) - want).max()
                    / np.abs(want.astype(np.float64)).max())
    check(ref_rel <= LM_REF_REL,
          f"{phase}: {what} rel err {ref_rel:.3e} > {LM_REF_REL}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tokens = [int(r.op_rows_in[lm_ix]) * seq for r in reports]
    for i, (rep, wall, peak, tok) in enumerate(zip(reports, walls, peaks,
                                                   tokens)):
        mem = "not measured" if peak is None else f"{peak / 2**30:.2f} GiB"
        print(f"{phase} batch {i}: {rep.rows_in} rows x {seq} tokens -> "
              f"{rep.rows_out}; lm_score {tok} tokens; wall {wall:.3f} s, "
              f"{tok / wall:.0f} tokens/s; peak memory {mem}; modeled "
              f"latency {rep.modeled_latency:.4f}")
    width = (f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
             f"{cfg.ssm_chunk}" if ssm
             else f"{cfg.n_heads} heads of {cfg.hd}")
    print(f"{phase}: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{width}, vocab {cfg.vocab_padded}) weights made in {init_s:.1f} "
          f"s; {calls} shard calls, launches {launched} ({want_per_call} "
          f"per call); {what} on a shard of {len(shard_rows)} rows: rel "
          f"err {ref_rel:.3e} (bar {LM_REF_REL})")
    if profile:
        groups = {"K6": ("ssd_scan",), "K7": ("rmsnorm",),
                  "K5": ("flash_attention",),
                  "f32 GEMM (dt projection, head)": F32_GEMM,
                  "bf16 GEMM": GEMM,
                  "conv/elementwise": ("elementwise", "vectorized",
                                       "unrolled", "cat", "reduce"),
                  "copies": ("memcpy", "memset")}
        prof = device_profile(torch, lambda: eng.run_batch(data[-1]), groups)
        print(f"{phase} profile (a third, profiled batch): {prof}")
    return {"launches": launched[main_kernel], "kernel_launches": launched,
            "calls": calls, "walls": walls, "tokens": tokens,
            "ref_rel": ref_rel,
            "shard_rows": max(len(r) for r, _, _ in shards)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core import costmodel
    from repro_torch.core.devices import ExplicitFleet, RegionFleetFamily
    from repro_torch.core.graph import random_dag
    from repro_torch.core.torchmodel import (edge_endpoints, region_factors,
                                             region_mass, region_onehot)
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import edge_latency as kernels
    from repro_torch.search.decision import joint_dq_scores
    from repro_torch.serve import (AdmissionConfig, QueryResult, WhatIfQuery,
                                   WhatIfService)
    from repro_torch.sim import BatchedEvaluator

    dev = torch.device(DEVICE)

    # -- 1. the card and the build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for "
          + ", ".join(f"{r.path.name} (nvcc {r.seconds:.1f} s)"
                      for r in built))
    for r in built:
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{r.name}]: {line.strip()}")
    print("kernels: " + "; ".join(
        f"{k} (cuda, {SOURCES[k]}, replaces {REPLACES[k]})"
        for k in SOURCES))

    # -- the serving instance (shared with the kernel phase's shapes) -------
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    graph = random_dag(N_OPS, EDGE_PROB, rng)
    E = graph.n_edges
    print(f"instance: random_dag({N_OPS}, {EDGE_PROB}) with E = {E} edges; "
          f"dense V = {DENSE_V}, S = {S}, P = {sum(DENSE_ROWS)}; structured "
          f"V = {STRUCT_V}, R = {STRUCT_R}, S = {S}, P = {sum(STRUCT_ROWS)}")
    region_d = rng.integers(0, 8, DENSE_V)
    base = rng.uniform(0.5, 4.0, (8, 8))
    base = (base + base.T) / 2
    np.fill_diagonal(base, 0.1)
    dense_pack = np.empty((S, DENSE_V, DENSE_V), np.float32)
    for s in range(S):      # region costs with per-link lognormal jitter
        c = base[region_d][:, region_d] * rng.lognormal(
            0.0, 0.25, (DENSE_V, DENSE_V))
        np.fill_diagonal(c, 0.0)
        dense_pack[s] = c
    dense_x = placements(torch, gen, sum(DENSE_ROWS), N_OPS, DENSE_V, 0.05)
    inter = rng.uniform(0.5, 4.0, (S, STRUCT_R, STRUCT_R))
    inter = (inter + inter.transpose(0, 2, 1)) / 2
    degrade = np.where(rng.random((S, STRUCT_V)) < 0.05,
                       rng.uniform(1.5, 4.0, (S, STRUCT_V)), 1.0)
    fam = RegionFleetFamily(region=rng.integers(0, STRUCT_R, STRUCT_V),
                            inter=inter, degrade=degrade, self_cost=0.01)
    struct_x = placements(torch, gen, sum(STRUCT_ROWS), N_OPS, STRUCT_V,
                          0.01)
    src = torch.as_tensor([i for i, _ in graph.edges], device=dev)
    dst = torch.as_tensor([j for _, j in graph.edges], device=dev)
    sel = torch.as_tensor([graph.operators[i].selectivity
                           for i, _ in graph.edges], dtype=torch.float32,
                          device=dev)

    # -- 2. kernels against their plain versions ------------------------------
    def hold(name, kernel, plain, args, what):
        out = kernel(*args)
        again = kernel(*args)
        want = plain(*(a.double() for a in args))
        torch.cuda.synchronize()
        rel, err = rel_err(out, want)
        check(out.shape == want.shape, f"{name} {what}: shape {out.shape}")
        check(rel <= REL, f"{name} {what}: rel err {rel:.3e} > {REL}")
        check(torch.equal(out, again), f"{name} {what}: repeat launch differs")
        return rel, err

    cases = 0
    worst = {k: 0.0 for k in kernels.KERNELS}
    for V in (7, 129, 300):
        for E_ in (1, 33, 130, 0):
            for shared in (True, False):
                B, bc = 3, 1 if shared else 3
                xi = torch.randn((B, E_, V), generator=gen, device=dev)
                xj = torch.randn((B, E_, V), generator=gen, device=dev)
                com = torch.randn((bc, V, V), generator=gen, device=dev)
                rel, _ = hold("edge_latency_dense",
                              kernels.edge_latency_dense,
                              ref.edge_latency_dense_plain, (xi, xj, com),
                              f"V={V} E={E_} shared={shared}")
                worst["edge_latency_dense"] = max(
                    worst["edge_latency_dense"], rel)
                cases += 1
                for R in (1, 8):
                    mass = torch.randn((B, E_, R), generator=gen, device=dev)
                    a = torch.randn((bc, R, V), generator=gen, device=dev)
                    corr = torch.randn((bc, 1, V), generator=gen, device=dev)
                    rel, _ = hold("edge_latency_structured",
                                  kernels.edge_latency_structured,
                                  ref.edge_latency_structured_plain,
                                  (xi, xj, mass, a, corr),
                                  f"V={V} E={E_} R={R} shared={shared}")
                    worst["edge_latency_structured"] = max(
                        worst["edge_latency_structured"], rel)
                    cases += 1
    # all-negative operands: a padded or skipped u column must never win
    V = 130
    xi = -torch.rand((2, 4, V), generator=gen, device=dev) - 0.5
    xj = torch.rand((2, 4, V), generator=gen, device=dev) + 0.5
    com = torch.rand((1, V, V), generator=gen, device=dev) + 0.5
    hold("edge_latency_dense", kernels.edge_latency_dense,
         ref.edge_latency_dense_plain, (xi, xj, com), "all-negative")
    check(float(kernels.edge_latency_dense(xi, xj, com).max()) < 0,
          "edge_latency_dense all-negative: a non-negative max")
    mass = torch.rand((2, 4, 8), generator=gen, device=dev)
    a = torch.rand((1, 8, V), generator=gen, device=dev)
    corr = torch.rand((1, 1, V), generator=gen, device=dev)
    hold("edge_latency_structured", kernels.edge_latency_structured,
         ref.edge_latency_structured_plain, (xi, xj, mass, a, corr),
         "all-negative")
    check(float(kernels.edge_latency_structured(xi, xj, mass, a, corr).max())
          < 0, "edge_latency_structured all-negative: a non-negative max")
    cases += 2
    print(f"kernels: {cases} small-shape cases within {REL} of float64 and "
          f"bitwise on repeat; worst rel err dense "
          f"{worst['edge_latency_dense']:.3e}, structured "
          f"{worst['edge_latency_structured']:.3e}")

    report = {}
    # K1 at the serving shape: the 1024-row chunk against one scenario
    x = torch.as_tensor(dense_x, device=dev)
    xi, xj = edge_endpoints(x, src, dst, sel)
    com = torch.as_tensor(dense_pack[:1], device=dev)
    rel, err = hold("edge_latency_dense", kernels.edge_latency_dense,
                    ref.edge_latency_dense_plain, (xi, xj, com),
                    "serving shape")
    B, V = xi.shape[0], xi.shape[2]
    flops = 2.0 * B * E * V * V + B * E * V
    bytes_ = 4.0 * (2 * B * E * V + V * V + B * E)
    report["edge_latency_dense"] = {
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda: kernels.edge_latency_dense(xi, xj, com), 5),
        "plain_ms": time_ms(
            lambda: ref.edge_latency_dense_plain(xi, xj, com), 5),
        "library_ms": time_ms(lambda: (xi * torch.einsum(
            "buv,bev->beu", com, xj)).amax(-1), 5),
        "flops": flops, "bytes": bytes_,
        "bound_ms": max(flops / PEAK_FP32, bytes_ / HBM_BW) * 1e3,
        "bound_by": "operations" if flops / PEAK_FP32 > bytes_ / HBM_BW
        else "bytes", "shape": f"B={B} E={E} V={V} com (1,V,V)"}
    del x, xi, xj, com
    # K2 at the serving shape: the 256-row chunk against one scenario
    x = torch.as_tensor(struct_x, device=dev)
    xi, xj = edge_endpoints(x, src, dst, sel)
    region_ix = torch.as_tensor(fam.region, device=dev)
    inter0 = torch.as_tensor(fam.inter[:1], dtype=torch.float32, device=dev)
    deg0 = torch.as_tensor(fam.degrade[:1], dtype=torch.float32, device=dev)
    mass = region_mass(xj, deg0, region_onehot(region_ix, STRUCT_R))
    a, corr = region_factors(inter0, deg0, region_ix, fam.self_cost)
    corr = corr[:, None, :].contiguous()
    args = (xi, xj, mass, a, corr)
    rel, err = hold("edge_latency_structured",
                    kernels.edge_latency_structured,
                    ref.edge_latency_structured_plain, args, "serving shape")
    B, V, R = xi.shape[0], xi.shape[2], STRUCT_R
    flops = B * E * V * (2.0 * R + 3)
    bytes_ = 4.0 * (2 * B * E * V + B * E * R + R * V + V + B * E)
    report["edge_latency_structured"] = {
        "max_abs_err": err, "rel_err": rel,
        "ms": time_ms(lambda: kernels.edge_latency_structured(*args), 20),
        "plain_ms": time_ms(
            lambda: ref.edge_latency_structured_plain(*args), 5),
        "library_ms": None, "flops": flops, "bytes": bytes_,
        "bound_ms": max(flops / PEAK_FP32, bytes_ / HBM_BW) * 1e3,
        "bound_by": "operations" if flops / PEAK_FP32 > bytes_ / HBM_BW
        else "bytes", "shape": f"B={B} E={E} V={V} R={R} shared scenario"}
    del x, xi, xj, mass, a, corr, args
    torch.cuda.empty_cache()
    for k, r in report.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        print(f"kernel {k} [{r['shape']}]: {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library {lib} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.1%} of it), rel err "
              f"{r['rel_err']:.3e}, max abs err {r['max_abs_err']:.3e}")

    # -- 2b. K4a / K4b against K1 / K2 ----------------------------------------
    tile = single_tile_phase(torch, dev)
    report.update(tile["report"])
    torch.cuda.empty_cache()

    # -- 3./4. the serving phases ---------------------------------------------
    def serve(phase, pack, xs, rows, kernel, oracle_fleet, same_rows):
        svc = WhatIfService(graph, device=dev,
                            admission=AdmissionConfig(p99_budget_s=1e6))
        fids = {svc.register_fleet(t, pack) for t in ("a", "b", "c")}
        check(len(fids) == 1, f"{phase}: equal packs got different ids")
        (fid,) = fids
        cuts = np.cumsum((0,) + rows)
        sl = [slice(int(cuts[i]), int(cuts[i + 1])) for i in range(3)]
        dqv = np.linspace(0.0, 1.0, 5)
        queries = [
            ("a", WhatIfQuery(kind="score", placements=xs[sl[0]], dq=0.3,
                              beta=0.7)),
            ("b", WhatIfQuery(kind="rank", placements=xs[sl[1]],
                              dq=np.linspace(0.1, 0.8, S), beta=1.3,
                              top_k=5)),
            ("c", WhatIfQuery(kind="joint", placements=xs[sl[2]],
                              dq_values=dqv, beta=0.5)),
        ]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        tickets = [svc.submit(t, fid, q) for t, q in queries]
        completed = svc.drain()
        wall = time.perf_counter() - t0
        launched = dict(kernels.launches)
        buckets = svc.stats.snapshot()["buckets"]
        dispatch_ms = [b["p50"] * 1e3 for b in buckets]   # one each
        n_disp = sum(b["dispatches"] for b in buckets)
        check(completed == 3, f"{phase}: {completed} queries completed")
        check(launched[kernel] > 0, f"{phase}: {kernel} never launched")
        results = {}
        for (t, q), tk in zip(queries, tickets):
            (res,) = [m for m in svc.poll(t) if isinstance(m, QueryResult)
                      and m.query_id == tk.query_id]
            results[t] = res
        ev = BatchedEvaluator.shared(graph, device=dev)
        packed = np.concatenate([q.placements for _, q in queries])

        def direct(i, dq, beta):
            # dense: the tenant's own rows (K1 is row-independent by
            # construction); structured: the rows exactly as dispatched,
            # since cuBLAS may sum the (rows, V) @ (V, R) mass product in
            # another order for another row count
            if same_rows:
                return ev.score_grid(packed, pack, dq=dq,
                                     beta=beta).cpu().numpy()[:, sl[i]]
            return ev.score_grid(queries[i][1].placements, pack, dq=dq,
                                 beta=beta).cpu().numpy()

        for i, (t, q) in enumerate(queries):
            res = results[t]
            if q.kind == "joint":
                want, _ = joint_dq_scores(direct(i, 0.0, 0.0), dqv, q.beta)
            else:
                want = direct(i, q.dq, q.beta)
            check(np.array_equal(res.scores, want),
                  f"{phase}: served {q.kind} scores differ from a direct "
                  f"score_grid")
        # float64 oracle on eight (scenario, placement) pairs of the score
        # query (dq = 0.3, β = 0.7)
        score = results["a"].scores
        worst_oracle = 0.0
        for k in range(8):
            s, p = k % S, int(rng.integers(0, rows[0]))
            lat = costmodel.latency(graph, oracle_fleet(s),
                                    xs[sl[0]][p].astype(np.float64))
            want = costmodel.objective_F(lat, 0.3, 0.7)
            err = abs(float(score[s, p]) - want) / abs(want)
            check(err <= REL, f"{phase}: oracle pair ({s}, {p}) rel err "
                              f"{err:.3e} > {REL}")
            worst_oracle = max(worst_oracle, err)
        # where the time goes: the same three queries once more, profiled
        prof = device_profile(torch, lambda: (
            [svc.submit(t, fid, q) for t, q in queries], svc.drain()))
        cells = S * sum(rows)
        print(f"{phase}: {completed} queries, {sum(rows)} rows x {S} "
              f"scenarios in {n_disp} dispatch(es); {completed / wall:.2f} "
              f"queries/s, {cells / wall:.0f} cells/s, wall {wall * 1e3:.1f} "
              f"ms, ms/dispatch {', '.join(f'{m:.1f}' for m in dispatch_ms)}"
              f"; set-up (kernel build) {svc.stats.setup_s:.3f} s; launches "
              f"{launched}; served == direct bitwise; oracle worst rel err "
              f"{worst_oracle:.3e}")
        print(f"{phase} profile (a second, profiled round): {prof}")
        return svc, ev, packed, launched

    _, _, _, dense_launched = serve(
        "serve_dense", dense_pack, dense_x, DENSE_ROWS,
        "edge_latency_dense",
        lambda s: ExplicitFleet(com_cost=dense_pack[s].astype(np.float64)),
        same_rows=False)
    # -- 3b. the same instance with all five objectives -----------------------
    speeds = rng.lognormal(0.0, 0.3, (S, DENSE_V)).astype(np.float32)
    serve_multi_phase(
        torch, np, dev, "serve_multi_dense", graph, dense_pack, dense_x,
        MULTI_DENSE_ROWS, speeds, "edge_latency_dense",
        lambda s: ExplicitFleet(com_cost=dense_pack[s].astype(np.float64),
                                speed=speeds[s].astype(np.float64)))
    del dense_pack, dense_x
    torch.cuda.empty_cache()
    _, ev, packed, struct_launched = serve(
        "serve_structured", fam, struct_x, STRUCT_ROWS,
        "edge_latency_structured", fam.fleet, same_rows=True)
    g1 = ev.score_grid(packed, fam, dq=0.2, beta=0.4).cpu()
    g2 = ev.score_grid(packed, fam, dq=0.2, beta=0.4).cpu()
    check(torch.equal(g1, g2), "serve_structured: two score_grid calls "
                               "differ (mass or kernel not deterministic)")
    check(bool(torch.isfinite(g1).all()) and g1.shape == (S, sum(STRUCT_ROWS)),
          "serve_structured: non-finite or mis-shaped grid")
    print("serve_structured: two score_grid calls bitwise equal")
    del ev, packed, g1, g2
    torch.cuda.empty_cache()

    # -- 4b. the same family with all five objectives -------------------------
    multi = serve_multi_phase(
        torch, np, dev, "serve_multi_structured", graph, fam, struct_x,
        MULTI_STRUCT_ROWS, None, "edge_latency_structured", fam.fleet)
    g1 = multi["ev"].score_grid(multi["padded"], fam, dq=0.2, beta=0.4,
                                objectives=multi["obj"]).to_host()
    g2 = multi["ev"].score_grid(multi["padded"], fam, dq=0.2, beta=0.4,
                                objectives=multi["obj"]).to_host()
    check(all(np.array_equal(g1.grids[k], g2.grids[k]) for k in g1.names)
          and np.array_equal(g1.scalarized, g2.scalarized),
          "serve_multi_structured: two score_grid(objectives=) calls differ")
    print("serve_multi_structured: two score_grid(objectives=) calls "
          "bitwise equal")
    del multi, g1, g2, fam, struct_x
    torch.cuda.empty_cache()

    # -- 5./6. K5 and the LM-scoring streaming job ----------------------------
    cfg = get_config(LM_ARCH).replace(attention_impl="pallas")
    shard = -(-LM_ROWS // 12)          # rows of the largest lm_score shard
    report["flash_attention"] = attention_phase(
        torch, dev, (shard, LM_SEQ, cfg.n_heads, cfg.hd))
    torch.cuda.empty_cache()
    lm = lm_score_phase(torch, np, dev, cfg, LM_ROWS, LM_SEQ, LM_BATCHES)
    check(lm["shard_rows"] <= shard,
          f"lm_score: a shard of {lm['shard_rows']} rows, K5 timed at {shard}")
    torch.cuda.empty_cache()        # the OLMo model went with the phase

    # -- 7./8. K6, K7 and the LM-scoring job on Mamba2 ------------------------
    ssm_cfg = get_config(SSM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    report.update(ssm_kernels_phase(torch, dev, shard, LM_SEQ, ssm_cfg))
    torch.cuda.empty_cache()
    ssm = lm_score_phase(torch, np, dev, ssm_cfg, LM_ROWS, LM_SEQ,
                         LM_BATCHES)
    check(ssm["shard_rows"] <= shard,
          f"lm_score_mamba2: a shard of {ssm['shard_rows']} rows, K6/K7 "
          f"timed at {shard}")

    launches = {"edge_latency_dense": dense_launched["edge_latency_dense"],
                "edge_latency_structured":
                    struct_launched["edge_latency_structured"],
                "flash_attention": lm["launches"],
                "ssd_scan": ssm["kernel_launches"]["ssd_scan"],
                "rmsnorm": ssm["kernel_launches"]["rmsnorm"],
                **tile["launches"]}
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": report[k]["max_abs_err"], "ms": report[k]["ms"],
         "plain_ms": report[k]["plain_ms"],
         "bound_ms": report[k]["bound_ms"],
         "bound_by": report[k]["bound_by"],
         "library_ms": report[k]["library_ms"]}
        for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
