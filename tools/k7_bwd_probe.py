#!/usr/bin/env python3
"""Probe K7's backward on one CUDA card: design variants and host time.

    python3 tools/k7_bwd_probe.py

Builds ``src/repro_torch/kernels/csrc/rmsnorm.cu`` as it is and in variants
made by replacing one line of its text (each built with ``nvcc`` into
``src/repro_torch/kernels/_build/probe/``), then times each at Granite's
(8192, 4096) and Mamba2's (8192, 2048) bf16 training shapes: the single
call, the device's time per kernel (``torch.profiler``), the same call
with the dw sum in a launch of its own, beside ``torch.add(x, g)`` (the
same bytes: two reads and one write) and the bytes bound.  Variants:

* ``runs``: each CTA takes a contiguous run of rows instead of rows
  b, b + G, ...;
* ``no_keep``: a row's values unpacked again for dx, w read again;
* ``no_barrier``, ``no_math``: diagnostics, wrong by design (the per-row
  barrier dropped; dx = x, no dw) — what the barrier and the math cost.

Each variant is held against the plain version first (the diagnostics
are reported, not held).  Last, the wrapper's host time piece by piece.
Without a card it exits 2.
"""

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((8192, 4096), (8192, 2048))


def variants(src: str) -> dict:
    """name → the source with one line replaced (``final``: as it is)."""
    subs = {
        "runs": ("  return {b, G, b < rows ? (rows - b + G - 1) / G : 0};",
                 "  return {b * rows / G, 1, (b + 1) * rows / G - b * rows "
                 "/ G};"),
        "no_keep": ("  constexpr bool KEEP = NV * n <= 16;",
                    "  constexpr bool KEEP = false;"),
        "no_barrier": ("  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] "
                       "= make_float2(ss, sg);\n  __syncthreads();",
                       "  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] "
                       "= make_float2(ss, sg);"),
        "no_math": ("          o[e] = r * gw - f * c;\n"
                    "          acc[j][e] = fmaf(gv, f * r, acc[j][e]);",
                    "          o[e] = f;"),
    }
    out = {"final": src}
    for name, (old, new) in subs.items():
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: its line is not in the source")
        out[name] = src.replace(old, new)
    return out


def build(torch_build, texts: dict) -> dict:
    """Each variant's library, built in parallel; name → ctypes.CDLL."""
    nvcc = torch_build.find_nvcc()
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    out = torch_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        f = out / f"rmsnorm_{name}.cu"
        f.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *torch_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out / f"{name}.so"), str(f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int64
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.rmsnorm_bwd_launch.argtypes = [P] * 6 + [I] * 3 + [
            ctypes.c_float, I, P]
        lib.rmsnorm_bwd_launch.restype = ctypes.c_int
        lib.rmsnorm_bwd_last_route.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def host_us(torch, fn, n: int = 2000) -> float:
    """Median host µs of one call of ``fn`` (the card synchronized after)."""
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(ts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k7_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build as torch_build
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.perf import roofline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    src = (ROOT / "src/repro_torch/kernels/csrc/rmsnorm.cu").read_text()
    libs = build(torch_build, variants(src))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    for rows, D in SHAPES:
        x = torch.randn(rows, D, generator=gen, device=dev).bfloat16()
        g = torch.randn(rows, D, generator=gen, device=dev).bfloat16()
        w = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        o = torch.empty_like(x)
        bound = roofline.rmsnorm_bwd_terms(rows, D, x.dtype).step_time_s
        add = cs.device_ms_per_call(torch, lambda: torch.add(x, g, out=o),
                                    20)
        plain = ref.rmsnorm_bwd_plain(x, w, g)
        wide_dw = ref.rmsnorm_bwd_plain(x.double(), w.double(),
                                        g.double())[1]
        print(f"({rows}, {D}) bf16 [{smi}]: bound {bound * 1e3:.4f} ms "
              f"(bytes); torch.add(x, g) device {add:.4f} ms")
        for name in [*libs, "final"]:       # the final design last again
            rk._bound_bwd = libs[name]
            dx, dw = rk.rmsnorm_bwd(x, w, g)
            route = rk.last_bwd_route()
            rel_dx = float((dx.float() - plain[0].float()).abs().max()
                           / plain[0].float().abs().max())
            rel_dw = float((dw.double() - wide_dw).abs().max()
                           / wide_dw.abs().max())
            held = "diagnostic" if name.startswith("no_m") or \
                name == "no_barrier" else (
                    "held" if rel_dx <= 1e-2 and rel_dw <= 1e-4 else "FAILED")
            ms = cs.time_ms(lambda: rk.rmsnorm_bwd(x, w, g), 30)
            _, per = cs.device_events(torch, lambda: [
                rk.rmsnorm_bwd(x, w, g) for _ in range(20)])
            alone = sum(t for k, (t, _) in per.items()
                        if "rmsnorm_bwd" in k) / 20
            _, per = cs.device_events(torch, lambda: [
                rk.rmsnorm_bwd(x, w, g, fuse=False) for _ in range(20)])
            rows_ms = sum(t for k, (t, _) in per.items() if "rmsnorm_bwd" in k
                          and "rmsnorm_bwd_dw" not in k) / 20
            dw_ms = sum(t for k, (t, _) in per.items()
                        if "rmsnorm_bwd_dw" in k) / 20
            print(f"  {name}: {held} (dx {rel_dx:.2e}, dw {rel_dw:.2e}), "
                  f"{route}; single call {ms:.4f} ms, the device alone "
                  f"{alone:.4f} ({bound * 1e3 / alone:.1%} of the bound); "
                  f"dw sum apart: rows {rows_ms:.4f}, dw sum {dw_ms:.4f}")
            if held == "FAILED":
                return 1
    rk._bound_bwd = libs["final"]
    x = torch.randn(8192, 4096, device=dev).bfloat16()
    g = torch.randn(8192, 4096, device=dev).bfloat16()
    w = torch.ones(4096, device=dev)
    parts = {
        "checks": lambda: rk._check(x, w),
        "empty_like (dx)": lambda: torch.empty_like(x),
        "empty (dw)": lambda: torch.empty(4096, dtype=torch.float32,
                                          device=dev),
        "empty (partials)": lambda: torch.empty((264, 4096),
                                                dtype=torch.float32,
                                                device=dev),
        "current_device": torch.cuda.current_device,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "the whole wrapper": lambda: rk.rmsnorm_bwd(x, w, g),
    }
    print(f"host µs a call [{smi}]: " + ", ".join(
        f"{k} {host_us(torch, fn, 300 if 'whole' in k else 2000):.2f}"
        for k, fn in parts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
