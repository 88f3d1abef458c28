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

The wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to
:func:`repro_torch.kernels.ref.ssd_scan_plain` — checks device, dtype,
shape, strides and the kernels' limits (P ≤ 64, N ≤ 128, shared memory),
launches on the current stream and raises if a launch was refused; nothing
falls back.  ``launches["ssd_scan"]`` counts calls of K6;
``route_launches`` counts each route's calls and each pass's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

__all__ = ["KERNELS", "ROUTES", "PASSES", "MAX_P", "MAX_N", "SMEM_LIMIT",
           "launches", "route_launches", "reset_launches", "route",
           "smem_bytes", "ssd_scan"]

KERNELS = ("ssd_scan",)
ROUTES = ("tensor_cores", "cuda_cores_f32")
PASSES = ("chunk_states", "state_passing", "output")
MAX_P, MAX_N = 64, 128
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use
launches = {name: 0 for name in KERNELS}
route_launches = {name: 0 for name in (*ROUTES, *PASSES)}

_P = ctypes.c_void_p
_I = ctypes.c_int64
_ENTRIES = {"cuda_cores_f32": "ssd_scan_f32_launch",
            "chunk_states": "ssd_scan_states_launch",
            "state_passing": "ssd_scan_pass_launch",
            "output": "ssd_scan_output_launch"}
_bound: ctypes.CDLL | None = None


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
    return (y, fs) if final_state else y
