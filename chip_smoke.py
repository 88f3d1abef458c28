#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

needs one CUDA card and the CUDA toolkit (``nvcc``); without a card, or run
from a directory that lacks ``src/repro_torch``, it exits non-zero and
prints no result.  It imports nothing of JAX or of the JAX package.

Phases, each raising on a failed check:

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/kernels/csrc/*.cu`` compiled with ``nvcc`` for
   ``sm_90a``, ptxas register / spill lines;
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
``score_grid`` calls are bitwise equal.  The launch counts are set to 0
just before a phase drives the service and read just after it.

The last lines are one JSON object per ported kernel list and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
KERNEL_SRC = "src/repro_torch/kernels/csrc/edge_latency.cu"
REPLACES = {"edge_latency_dense": "src/repro/kernels/edge_latency.py:160",
            "edge_latency_structured": "src/repro/kernels/edge_latency.py:246"}


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


def device_profile(torch, fn) -> str:
    """One call of ``fn`` under ``torch.profiler``: wall time, the summed
    device time of its kernels and copies (one stream, so the sum is the
    busy time), the idle share, and the largest device consumers."""
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
    if not per_name:
        return f"wall {wall_ms:.1f} ms; the profiler recorded no device events"
    busy = sum(v[0] for v in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    return (f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle "
            f"{max(0.0, 1 - busy / wall_ms):.1%}; top: " + "; ".join(
                f"{n[:48]} {t:.2f} ms x{c}" for n, (t, c) in top))


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
        f"{k} (cuda, {KERNEL_SRC}, replaces {REPLACES[k]})"
        for k in kernels.KERNELS))

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
    del dense_pack, dense_x
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

    launches = {"edge_latency_dense": dense_launched["edge_latency_dense"],
                "edge_latency_structured":
                    struct_launched["edge_latency_structured"]}
    print(smi)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SRC,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": report[k]["max_abs_err"], "ms": report[k]["ms"],
         "plain_ms": report[k]["plain_ms"],
         "bound_ms": report[k]["bound_ms"],
         "bound_by": report[k]["bound_by"],
         "library_ms": report[k]["library_ms"]}
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
