"""Wrapper of the hand-written CUDA C++ SSD chunked-scan kernel (K6).

:func:`ssd_scan` replaces the Pallas kernel
``repro.kernels.ssd_scan.ssd_scan_pallas`` and computes what the Mamba2
forward's ``ssd_chunked`` returns as y; ``csrc/ssd_scan.cu``'s header says
what bounds it and how it is tiled.  It reads x (b, L, H, P) and B, C
(b, L, N) through their strides (the model passes views of one conv
output), takes any L (the ragged last chunk is masked in the kernel), any
H and the chunk Q from the caller, and writes a new contiguous y in x's
dtype.  With ``final_state=True`` it also returns ``ssd_chunked``'s second
output, the state after the last row, (b, H, N, P) in float32: the Mamba2
prefill keeps it as its cache.  y is bitwise the same either way.

The route is the dtype, stated here and nowhere else:

* bfloat16 operands take the tensor cores (route ``"tensor_cores"``), in
  three chunk-parallel passes: chunk states (``"chunk_states"``), state
  passing (``"state_passing"``, only when there is more than one chunk)
  and output (``"output"``).  The wrapper allocates their scratch with
  :func:`torch.empty`: the in-chunk cumsums (b, n, H, Q) and the chunk
  states (b, n − 1, H, N, P) in float32, the carried-in states
  (b, n − 1, H, N rounded up to 16, 64) in bfloat16, n = ceil(L / Q).
  The final state, when asked for, is the last chunk's state from the
  first pass, carried in by the second.
* float32 operands take the CUDA cores (route ``"cuda_cores_f32"``), one
  kernel that walks the chunks in order: no tensor-core format keeps
  float32's 1e-5.  With the final state asked for it also updates the
  state after the last chunk and writes it.

:func:`ssd_scan_bwd` is K6's gradient, kernels of their own in
``csrc/ssd_scan_bwd.cu`` (the Pallas kernel has none: the reference trains
through ``jax.grad`` of ``ssd_chunked``).  From x, B, C, dt, A, D and the
upstream gradient dy of y it writes (dx, dB, dC, ddt, dA, dD), each in its
operand's dtype, deterministically, in four passes on either route
(``route_launches`` counts each): ``"bwd_states"`` (the cumsums, the
recomputed chunk states and each chunk's share of the state gradient),
``"bwd_state_passing"``, ``"bwd_chunk"`` (every gradient of a chunk) and
``"bwd_reduce"`` (dB, dC over head blocks, dA, dD over chunks).  The route
is the dtype again: bfloat16 operands take the tensor cores (a chunk CTA
per 2 heads, ``BWD_TC_HB``), float32 the CUDA cores (per 4 heads,
``BWD_HB``).
:class:`SSDScanFunction` ties the two together for autograd: its forward
launches :func:`ssd_scan` and saves the operands, its backward launches
:func:`ssd_scan_bwd`.  Both are looked up in this module when called, so a
caller may swap either for another version.  The final state is not
differentiated: no training path asks for it.

The wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to
:func:`repro_torch.kernels.ref.ssd_scan_plain` — checks device, dtype,
shape, strides and the kernels' limits (P ≤ 64, N ≤ 128, shared memory),
launches on the current stream and raises if a launch was refused; nothing
falls back.  ``launches["ssd_scan"]`` counts calls of K6 and
``launches["ssd_scan_bwd"]`` calls of its backward;
``route_launches`` counts each route's calls and each pass's launches.  A
call reports :func:`repro_torch.perf.roofline.ssd_scan_terms` for its shape
to an open ``repro_torch.perf.counts`` counter, once for all its passes
(the backward :func:`~repro_torch.perf.roofline.ssd_scan_bwd_terms`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.perf import counts, roofline

__all__ = ["KERNELS", "ROUTES", "PASSES", "BWD_PASSES", "MAX_P", "MAX_N",
           "SMEM_LIMIT", "launches", "route_launches", "reset_launches",
           "route", "smem_bytes", "bwd_smem_bytes", "bwd_ssp_count",
           "ssd_scan", "ssd_scan_bwd", "SSDScanFunction"]

KERNELS = ("ssd_scan", "ssd_scan_bwd")
ROUTES = ("tensor_cores", "cuda_cores_f32")
PASSES = ("chunk_states", "state_passing", "output")
BWD_PASSES = ("bwd_states", "bwd_state_passing", "bwd_chunk", "bwd_reduce")
MAX_P, MAX_N = 64, 128
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
launches = {name: 0 for name in KERNELS}
route_launches = {name: 0 for name in (*ROUTES, *PASSES, *BWD_PASSES)}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_ENTRIES = {"cuda_cores_f32": "ssd_scan_f32_launch",
            "chunk_states": "ssd_scan_states_launch",
            "state_passing": "ssd_scan_pass_launch",
            "output": "ssd_scan_output_launch"}
_BWD_ENTRIES = {"bwd_states": "ssd_bwd_states_launch",
                "bwd_state_passing": "ssd_bwd_pass_launch",
                "bwd_chunk": "ssd_bwd_chunk_launch",
                "bwd_reduce": "ssd_bwd_reduce_launch"}
_bound: ctypes.CDLL | None = None
_bound_bwd: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    for name in route_launches:
        route_launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("ssd_scan")
        for entry in _ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [_P] * 11 + [_I] * 16 + [_P]
            fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _bwd_lib() -> ctypes.CDLL:
    global _bound_bwd
    if _bound_bwd is None:
        lib = build.load("ssd_scan_bwd")
        for entry in _BWD_ENTRIES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [_P] * 23 + [_I] * 20 + [_P]
            fn.restype = ctypes.c_int
        lib.ssd_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        _bound_bwd = lib
    return _bound_bwd


def route(dtype: torch.dtype) -> str:
    """The route K6 takes for operands of ``dtype``."""
    return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores_f32"


def smem_bytes(N: int, P: int, Q: int) -> dict[str, int]:
    """Shared memory one CTA of each kernel takes for (N, P, Q), in bytes,
    by the layouts of ``csrc/ssd_scan.cu``.

    * ``cuda_cores_f32``: 4 heads' float32 states, C/B tiles of 32 rows
      with a pitch of N+1, the x tile, the C·Bᵀ tile and three (4, Q) scan
      rows;
    * ``chunk_states``: two stages of a B tile and 2 heads' x tiles (64
      rows × 64 bf16 per swizzle block, N in two blocks of 64) and the
      (2, Q) weights, plus 1 KB to align the swizzle atoms;
    * ``output``: the C tile, two stages of a B tile and 2 heads' x tiles
      (the second holds the carried-in states before the key loop), the
      (2, Q) cumsums and dt and (2, 64) column decays, plus the same 1 KB.
    The state-passing pass takes none."""
    T, HB = 32, 4
    tile, nblk = 64 * 128, MAX_N // 64
    return {
        "cuda_cores_f32": 4 * (HB * N * P + T * (N + 1)
                               + max(T * (N + 1), HB * T * (T + 1))
                               + T * HB * P + T * (T + 1) + 3 * HB * Q),
        "chunk_states": 1024 + 2 * (nblk + 2) * tile
                        + 4 * 2 * (-(-Q // 64) * 64),
        "output": 1024 + nblk * tile + 2 * (nblk + 2) * tile
                  + 4 * 2 * (2 * (-(-Q // 64) * 64) + 64),
    }


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
             chunk: int, final_state: bool = False,
             state_out: torch.Tensor | None = None):
    """K6: x (b, L, H, P), B and C (b, L, N) float32 or bfloat16 (one
    dtype), dt (b, L, H), A and D (H,) float32 → y (b, L, H, P) in x's
    dtype, chunks of ``min(chunk, L)`` rows (see the module docstring);
    ``(y, state)`` with the float32 (b, H, N, P) final state when
    ``final_state``, written into ``state_out`` (contiguous, on x's card)
    when one is given."""
    b, L, H, P, N, Q = ref.check_ssd_operands(x, B, C, dt, A, D, chunk)
    dev = x.device
    for name, t in (("x", x), ("B", B), ("C", C), ("dt", dt), ("A", A),
                    ("D", D)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version serves CPU tensors), got device "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if state_out is not None:
        final_state = True
        if (tuple(state_out.shape) != (b, H, N, P)
                or state_out.dtype != torch.float32
                or not state_out.is_contiguous()
                or state_out.device != dev):
            raise ValueError(
                f"state_out must be a contiguous float32 {(b, H, N, P)} "
                f"tensor on {dev}; got {tuple(state_out.shape)} "
                f"{state_out.dtype} on {state_out.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x, B, C must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError(f"x needs a contiguous head dim and B, C a "
                         f"contiguous state dim; got strides {x.stride()}, "
                         f"{B.stride()}, {C.stride()}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"head dim {P} / state {N} above the kernel's "
                         f"{MAX_P} / {MAX_N}")
    way = route(x.dtype)
    need = smem_bytes(N, P, Q)
    for k in ((way,) if way == "cuda_cores_f32" else ("chunk_states",
                                                       "output")):
        if need[k] > SMEM_LIMIT:
            raise ValueError(f"chunk {Q} needs {need[k]} bytes of shared "
                             f"memory in {k}, above {SMEM_LIMIT}")
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    fs = state_out if state_out is not None else \
        torch.empty((b, H, N, P), **f32) if final_state else None
    if y.numel() == 0:
        return (y, fs.zero_()) if final_state else y
    n = -(-L // Q)
    if way == "tensor_cores":
        cum = torch.empty((b, n, H, Q), **f32)
        s = torch.empty((b, n - 1, H, N, P), **f32)
        Sb = torch.empty((b, n - 1, H, -(-N // 16) * 16, 64),
                         dtype=torch.bfloat16, device=dev)
        passes = ("chunk_states",) + (("state_passing",) if n > 1 else ()) \
            + ("output",)
    else:                            # the float32 kernel takes no scratch
        cum = s = Sb = y
        passes = ("cuda_cores_f32",)
    lib = _lib()
    with torch.cuda.device(dev):     # launch on the operands' card
        args = (x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
                A.data_ptr(), D.data_ptr(), y.data_ptr(), cum.data_ptr(),
                s.data_ptr(), Sb.data_ptr(),
                None if fs is None else fs.data_ptr(), b, L, H, P, N, Q,
                *x.stride()[:3], *B.stride()[:2], *C.stride()[:2],
                *dt.stride(), torch.cuda.current_stream(dev).cuda_stream)
        for p in passes:
            rc = getattr(lib, _ENTRIES[p])(*args)
            if rc != 0:
                raise RuntimeError(
                    f"ssd_scan {p} launch failed: "
                    f"{lib.ssd_scan_error_string(rc).decode()}")
            if p in PASSES:
                route_launches[p] += 1
    route_launches[way] += 1
    launches["ssd_scan"] += 1
    if counts.ACTIVE:
        counts.report_kernel("ssd_scan", roofline.ssd_scan_terms(
            b, L, H, P, N, Q, x.dtype))
    return (y, fs) if final_state else y


# csrc/ssd_scan_bwd.cu's tiles: the float32 route 32 rows in pass 1, 64
# rows and 4 heads a CTA in pass 3; the bfloat16 route 2 heads a pass-3 CTA
BWD_T1, BWD_T, BWD_HB = 32, 64, 4
BWD_TC_HB = 2


def bwd_ssp_count(N: int, P: int) -> int:
    """The bfloat16 route's partial sums of ⟨S_c, dS_{c+1}⟩ a (batch,
    chunk, head): one a warp of its state-passing pass, whose threads take
    4 columns of a state row (1 where P % 4 != 0) of N rounded up to 16."""
    return (-(-N // 16) * 16) * (64 // (4 if P % 4 == 0 else 1)) // 32


def bwd_smem_bytes(N: int, P: int, Q: int) -> dict[str, dict[str, int]]:
    """Shared memory one CTA of the backward's passes 1 and 3 takes for
    (N, P, Q), in bytes, per route, by the layouts of
    ``csrc/ssd_scan_bwd.cu``.  ``"cuda_cores_f32"``: pass 1 the (Q,)
    cumsums and its scan's 8 warp sums in float64, two (Q,) rows and B, C
    (pitch N + 1), x, dy (pitch P + 1) tiles of 32 rows in float32; pass 3
    three (4, Q) rows in float64 (the cumsums, the row and column sums that
    cancel in dcum), then C, B, x, dy tiles of 64 rows, four (64, 65) tiles
    (the staged states overlay them), three (4, Q) rows and a few floats
    for its reductions.  ``"tensor_cores"`` (bf16 tiles of 64 rows × 64
    columns, 8 KB, in the 128-byte swizzle, N in two of them; Q rounded up
    to 64 as Qp): pass 1 two stages of a B or C tile and an x or dy tile,
    the (Qp,) cumsums in float64 and row weights in float32; pass 3 B_jt
    and two heads' x_jt, two stages of C_it and two heads' dy_it, the
    second of which with the bytes after it holds two heads' S_c and
    dS_{c+1} while the state terms are formed, and else the row sums of T
    a (warp, row group) and column for each head (a pitch of 65 float64),
    to the next 1 KB; the dG tile; dB's float32 accumulator and a share of
    the other head's dx (a 64 × 64 fragment each a warpgroup); per head two
    (Qp,) rows in float64 (the cumsums, the row sums of T) and three in
    float32, the column sums of R (x . dy) per warpgroup and head in
    float64, the column decays, a few floats and each thread's x · dy;
    each plus 1 KB to align the swizzle atoms.
    Passes 2 and 4 take none."""
    T, T1, HB = BWD_T, BWD_T1, BWD_HB
    tile, nblk, hb, qp = 64 * 128, MAX_N // 64, BWD_TC_HB, -(-Q // 64) * 64
    return {
        "cuda_cores_f32": {
            "bwd_states": 8 * (Q + 8) + 4 * (2 * Q + 2 * T1 * (N + 1)
                                             + 2 * T1 * (P + 1)),
            "bwd_chunk": 8 * 3 * HB * Q + 4 * (2 * T * (N + 1)
                                               + 2 * T * (P + 1)
                                               + 4 * T * (T + 1) + 3 * HB * Q
                                               + 8 + 2 * HB)},
        "tensor_cores": {
            "bwd_states": 1024 + 2 * (nblk + 1) * tile + 12 * qp,
            "bwd_chunk": 1024 + 2 * (nblk + hb) * tile
                         + -(-max(hb * 2 * nblk * tile,
                                  (nblk + hb) * tile + hb * 32 * 65 * 8)
                             // 1024) * 1024
                         + tile + 2 * hb * 32 * 128 * 4 + hb * qp * 28
                         + hb * hb * qp * 8 + hb * 256 + 64
                         + 128 * hb * 4}}


def ssd_scan_bwd(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, chunk: int):
    """K6's backward: the operands of :func:`ssd_scan` and dy (b, L, H, P)
    in x's dtype (P contiguous, any other strides) → (dx, dB, dC, ddt, dA,
    dD): dx contiguous in x's dtype, dB and dC contiguous (b, L, N) in B's,
    ddt (b, L, H), dA and dD (H,) float32 — the gradient of y, as
    :func:`repro_torch.kernels.ref.ssd_scan_bwd_plain` writes it.
    Deterministic: a repeat launch is bitwise identical."""
    b, L, H, P, N, Q = ref.check_ssd_operands(x, B, C, dt, A, D, chunk)
    dev = x.device
    for name, t in (("x", x), ("B", B), ("C", C), ("dt", dt), ("A", A),
                    ("D", D), ("dy", dy)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version serves CPU tensors), got device "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x, B, C must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(dy.shape) != (b, L, H, P) or dy.dtype != x.dtype:
        raise ValueError(f"dy ({tuple(dy.shape)}, {dy.dtype}) must be y's "
                         f"shape {(b, L, H, P)} and x's dtype {x.dtype}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1 \
            or dy.stride(-1) != 1:
        raise ValueError(f"x and dy need a contiguous head dim and B, C a "
                         f"contiguous state dim; got strides {x.stride()}, "
                         f"{dy.stride()}, {B.stride()}, {C.stride()}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"head dim {P} / state {N} above the kernel's "
                         f"{MAX_P} / {MAX_N}")
    way = route(x.dtype)
    for k, need in bwd_smem_bytes(N, P, Q)[way].items():
        if need > SMEM_LIMIT:
            raise ValueError(f"chunk {Q} needs {need} bytes of shared "
                             f"memory in {k}, above {SMEM_LIMIT}")
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((b, L, N), dtype=B.dtype, device=dev)
    dC = torch.empty((b, L, N), dtype=C.dtype, device=dev)
    ddt = torch.empty((b, L, H), **f32)
    dA, dD = torch.empty(H, **f32), torch.empty(H, **f32)
    if dx.numel() == 0:
        return (dx, dB.zero_(), dC.zero_(), ddt.zero_(), dA.zero_(),
                dD.zero_())
    n = -(-L // Q)
    tc = way == "tensor_cores"
    nhb = -(-H // (BWD_TC_HB if tc else BWD_HB))
    # the float32 route adds into its partials; the bf16 route writes each
    # element before it adds to it, in rows of N rounded up to even
    part = torch.empty if tc else torch.zeros
    width = N + N % 2 if tc else N
    dBp = part((b, L, nhb, width), **f32)
    dCp = part((b, L, nhb, width), **f32)
    dAp, dDp = torch.empty((b, n, H), **f32), torch.empty((b, n, H), **f32)
    cum = torch.empty((b, n, H, Q), dtype=torch.float64, device=dev)
    s = torch.empty((b, n, H, N, P), **f32)
    ds = torch.empty((b, n, H, N, P), **f32)
    if tc:
        npad = -(-N // 16) * 16
        Sb = torch.empty((b, n, H, npad, 64), dtype=torch.bfloat16,
                         device=dev)
        dSb = torch.empty_like(Sb)
        ssp = torch.empty((b, n, H, bwd_ssp_count(N, P)), **f32)
    else:                            # the float32 route takes no more
        Sb = dSb = ssp = s
    A, D = A.contiguous(), D.contiguous()
    lib = _bwd_lib()
    with torch.cuda.device(dev):     # launch on the operands' card
        args = (x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
                A.data_ptr(), D.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
                dAp.data_ptr(), dDp.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                dA.data_ptr(), dD.data_ptr(), cum.data_ptr(), s.data_ptr(),
                ds.data_ptr(), Sb.data_ptr(), dSb.data_ptr(), ssp.data_ptr(),
                b, L, H, P, N, Q,
                int(x.dtype == torch.bfloat16), *x.stride()[:3],
                *B.stride()[:2], *C.stride()[:2], *dt.stride(),
                *dy.stride()[:3], torch.cuda.current_stream(dev).cuda_stream)
        for p in BWD_PASSES:
            rc = getattr(lib, _BWD_ENTRIES[p])(*args)
            if rc != 0:
                raise RuntimeError(
                    f"ssd_scan backward {p} launch failed: "
                    f"{lib.ssd_bwd_error_string(rc).decode()}")
            route_launches[p] += 1
    launches["ssd_scan_bwd"] += 1
    if counts.ACTIVE:
        counts.report_kernel("ssd_scan_bwd", roofline.ssd_scan_bwd_terms(
            b, L, H, P, N, Q, x.dtype))
    return dx, dB, dC, ddt, dA, dD


class SSDScanFunction(torch.autograd.Function):
    """K6 with its gradient: forward :func:`ssd_scan` (the operands saved,
    nothing else kept), backward :func:`ssd_scan_bwd` on the upstream
    gradient (its head dim made contiguous where it is not)."""

    @staticmethod
    def forward(ctx, x, B, C, dt, A, D, chunk):
        ctx.save_for_backward(x, B, C, dt, A, D)
        ctx.chunk = chunk
        return ssd_scan(x, B, C, dt, A, D, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, B, C, dt, A, D = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        return (*ssd_scan_bwd(x, B, C, dt, A, D, dy, ctx.chunk), None)
