"""Wrappers of the hand-written CUDA C++ edge-latency kernels.

``csrc/edge_latency.cu`` holds both kernels; its header says how each is
tiled.  In brief:

* :func:`edge_latency_dense` (K1) replaces the Pallas kernel
  ``repro.kernels.edge_latency.edge_latency_pallas``.  It is bound by
  operations (``2·B·E·V²`` multiply-adds).  Plain TF32 would miss the 1e-5
  bar, so it runs on the tensor cores (wgmma) in split TF32 (three TF32
  products per multiply-add, each 32-deep v stage in a fresh accumulator),
  a GEMM tile with the row max fused into the epilogue — the (B, E, V)
  product ``com @ x_j`` never reaches device memory.  The wrapper allocates
  its scratch: com's TF32 hi and lo parts (split once per launch) and a
  partial max per 128-wide u tile, which a finish kernel reduces.
* :func:`edge_latency_structured` (K2) replaces
  ``repro.kernels.edge_latency.edge_latency_structured_pallas``.  It is
  bound by HBM bytes (x_i and x_j are read once; R ≪ V), so it streams u
  with coalesced loads and keeps each CTA's (8, R) ``mass`` tile in shared
  memory.
* :func:`edge_latency_dense_single_tile` (K4a) and
  :func:`edge_latency_structured_single_tile` (K4b) replace the whole-V
  references ``edge_latency_pallas_single_tile`` and
  ``edge_latency_structured_pallas_single_tile``: the same functions as K1
  and K2 with every operand tile resident in shared memory, the bitwise
  references K1 and K2 are held against at small V.  They refuse, before
  any launch, operands whose tiles exceed the 227 KB a CTA can use
  (:func:`single_tile_max_v`: V ≤ 237 for K4a; V ≤ 6449 for K4b at R = 8).
  K4b runs a persistent grid that copies a scenario's tile once per CTA
  and streams the edge rows' x_i and x_j past it.

Each wrapper takes CUDA tensors only — the device policy in
:mod:`repro_torch.kernels.dispatch` sends CPU tensors to the plain versions
in :mod:`repro_torch.kernels.ref` — checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream and raises if the launch was refused.  E = 0 returns a
(B, 0) tensor without a launch.  ``launches[name]`` counts launches, so a
run can show that its main path went through the kernels, and each launch
reports its work to an open ``repro_torch.perf.counts`` counter (K1/K4a:
``2·B·E·V²`` operations, K2/K4b: ``2·B·E·R·V``, with the bytes of
``repro_torch.perf.roofline``'s terms).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.perf import counts, roofline

__all__ = ["KERNELS", "launches", "reset_launches", "edge_latency_dense",
           "edge_latency_structured", "edge_latency_dense_single_tile",
           "edge_latency_structured_single_tile", "SMEM_LIMIT",
           "single_tile_smem_bytes", "single_tile_max_v",
           "check_single_tile"]

KERNELS = ("edge_latency_dense", "edge_latency_structured",
           "edge_latency_dense_single_tile",
           "edge_latency_structured_single_tile")
launches = {name: 0 for name in KERNELS}

# the shared memory one CTA may opt in to on Hopper (227 KB), the edge
# rows a single-tile CTA stages (T_ROWS in csrc/edge_latency.cu) and K1's
# u tile (K1_BN), one partial max per row and u tile
SMEM_LIMIT = 232_448
TILE_ROWS = 8
DENSE_TILE_U = 128

_P = ctypes.c_void_p
_I = ctypes.c_int64
_bound: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("edge_latency")
        lib.edge_latency_dense_launch.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.edge_latency_dense_launch.restype = ctypes.c_int
        lib.edge_latency_structured_launch.argtypes = \
            [_P] * 6 + [_I] * 12 + [_P]
        lib.edge_latency_structured_launch.restype = ctypes.c_int
        lib.edge_latency_dense_single_tile_launch.argtypes = \
            [_P] * 4 + [_I] * 6 + [_P]
        lib.edge_latency_dense_single_tile_launch.restype = ctypes.c_int
        lib.edge_latency_structured_single_tile_launch.argtypes = \
            [_P] * 6 + [_I] * 9 + [_P]
        lib.edge_latency_structured_single_tile_launch.restype = ctypes.c_int
        lib.edge_latency_error_string.argtypes = [ctypes.c_int]
        lib.edge_latency_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (the plain version "
                         f"serves CPU tensors), got device {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x_i on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, tensors: tuple, ints: tuple, terms) -> None:
    """Call ``<name>_launch`` with the tensors' pointers, the integer
    shape/stride arguments and the current stream; count the launch and
    report ``terms()`` (its roofline terms) to an open counter."""
    lib = _lib()
    dev = tensors[0].device
    with torch.cuda.device(dev):     # launch on the operands' card
        rc = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in tensors), *ints,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.edge_latency_error_string(rc).decode()}")
    launches[name] += 1
    if counts.ACTIVE:
        counts.report_kernel(name, terms())


def edge_latency_dense(x_i: torch.Tensor, x_j: torch.Tensor,
                       com: torch.Tensor) -> torch.Tensor:
    """K1: x_i, x_j (B, E, V) with selectivity folded into x_i; com
    (B, V, V) or (1, V, V) → (B, E) ``max_u x_i·(com @ x_j)_u``.  A shared
    com (batch 1) is read with batch stride 0 and the (B, E) rows are
    flattened into one row axis, so it is never replicated."""
    B, E, V = x_i.shape
    dev = x_i.device
    bc = com.shape[0]
    if bc not in (1, B):
        raise ValueError(f"com batch dim {bc} must be 1 or {B}")
    for name, t, shape in (("x_i", x_i, (B, E, V)), ("x_j", x_j, (B, E, V)),
                           ("com", com, (bc, V, V))):
        _check(name, t, shape, dev)
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    shared = bc == 1
    n_batch, rows = (1, B * E) if shared else (B, E)
    com_hi, com_lo = torch.empty_like(com), torch.empty_like(com)
    partial = torch.empty((n_batch, -(-V // DENSE_TILE_U), rows),
                          dtype=torch.float32, device=dev)
    _launch("edge_latency_dense",
            (x_i, x_j, com, com_hi, com_lo, partial, out),
            (n_batch, rows, V, E * V, V, 0 if shared else V * V, V, E,
             com.numel()),
            lambda: roofline.edge_latency_dense_terms(B, E, V, bc))
    return out


def edge_latency_structured(x_i: torch.Tensor, x_j: torch.Tensor,
                            mass: torch.Tensor, a: torch.Tensor,
                            corr: torch.Tensor) -> torch.Tensor:
    """K2: x_i, x_j (B, E, V); mass (B, E, R); a (Bc, R, V); corr
    (Bc, 1, V), Bc ∈ {1, B} → (B, E) ``max_u x_i·(mass @ a + corr·x_j)``.
    A shared scenario (Bc = 1) is read with batch stride 0."""
    B, E, V = x_i.shape
    R = mass.shape[-1]
    dev = x_i.device
    bc = a.shape[0]
    if bc not in (1, B) or corr.shape[0] != bc:
        raise ValueError(f"scenario batch dims {bc}/{corr.shape[0]} must "
                         f"match and be 1 or {B}")
    for name, t, shape in (("x_i", x_i, (B, E, V)), ("x_j", x_j, (B, E, V)),
                           ("mass", mass, (B, E, R)), ("a", a, (bc, R, V)),
                           ("corr", corr, (bc, 1, V))):
        _check(name, t, shape, dev)
    if R < 1:
        raise ValueError("structured kernel needs R >= 1 regions")
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    shared = bc == 1
    n_batch, rows = (1, B * E) if shared else (B, E)
    _launch("edge_latency_structured", (x_i, x_j, mass, a, corr, out),
            (n_batch, rows, V, R, E * V, V, E * R, R,
             0 if shared else R * V, V, 0 if shared else V, E),
            lambda: roofline.edge_latency_structured_single_tile_terms(
                B, E, V, R, bc))    # K2's function
    return out


def single_tile_smem_bytes(V: int, R: int | None = None) -> int:
    """Shared memory of one single-tile CTA: K4a (``R is None``) holds com
    (V rows at an odd pitch) and 8 x_j rows; K4b holds a (R, V), corr (V)
    and 8 mass rows."""
    if R is None:
        return 4 * (V * (V | 1) + TILE_ROWS * V)
    return 4 * ((R + 1) * V + TILE_ROWS * R)


def single_tile_max_v(R: int | None = None) -> int:
    """The largest V the single-tile kernel accepts (237 for K4a; for K4b
    it depends on R: 6449 at R = 8)."""
    V = 1
    while single_tile_smem_bytes(V + 1, R) <= SMEM_LIMIT:
        V += 1
    return V


def check_single_tile(V: int, R: int | None = None) -> None:
    """Raise ValueError when the resident tiles for this V (and R) exceed
    the 227 KB a CTA can use — the reference's "do not use for large V"."""
    need = single_tile_smem_bytes(V, R)
    if need > SMEM_LIMIT:
        which = "K4a (dense)" if R is None else f"K4b (structured, R={R})"
        raise ValueError(
            f"single-tile {which} needs {need} bytes of shared memory at "
            f"V={V}, over the {SMEM_LIMIT} a CTA can use; the largest V "
            f"accepted is {single_tile_max_v(R)} — use the blocked kernel")


def edge_latency_dense_single_tile(x_i: torch.Tensor, x_j: torch.Tensor,
                                   com: torch.Tensor) -> torch.Tensor:
    """K4a: K1's function (x_i, x_j (B, E, V), com (B|1, V, V) → (B, E))
    with the whole com tile resident; bitwise equal to K1.  Raises
    ValueError for V over :func:`single_tile_max_v` before any launch."""
    B, E, V = x_i.shape
    check_single_tile(V)
    dev = x_i.device
    bc = com.shape[0]
    if bc not in (1, B):
        raise ValueError(f"com batch dim {bc} must be 1 or {B}")
    for name, t, shape in (("x_i", x_i, (B, E, V)), ("x_j", x_j, (B, E, V)),
                           ("com", com, (bc, V, V))):
        _check(name, t, shape, dev)
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    _launch("edge_latency_dense_single_tile", (x_i, x_j, com, out),
            (B, E, V, E * V, 0 if bc == 1 else V * V, E),
            lambda: roofline.edge_latency_single_tile_terms(B, E, V, bc))
    return out


def edge_latency_structured_single_tile(x_i: torch.Tensor,
                                        x_j: torch.Tensor,
                                        mass: torch.Tensor, a: torch.Tensor,
                                        corr: torch.Tensor) -> torch.Tensor:
    """K4b: K2's function (x_i, x_j (B, E, V); mass (B, E, R); a (Bc, R, V);
    corr (Bc, 1, V) → (B, E)) with a, corr and the mass rows resident;
    bitwise equal to K2.  Raises ValueError for tiles over 227 KB before
    any launch."""
    B, E, V = x_i.shape
    R = mass.shape[-1]
    if R < 1:
        raise ValueError("structured kernel needs R >= 1 regions")
    check_single_tile(V, R)
    dev = x_i.device
    bc = a.shape[0]
    if bc not in (1, B) or corr.shape[0] != bc:
        raise ValueError(f"scenario batch dims {bc}/{corr.shape[0]} must "
                         f"match and be 1 or {B}")
    for name, t, shape in (("x_i", x_i, (B, E, V)), ("x_j", x_j, (B, E, V)),
                           ("mass", mass, (B, E, R)), ("a", a, (bc, R, V)),
                           ("corr", corr, (bc, 1, V))):
        _check(name, t, shape, dev)
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    shared = bc == 1
    _launch("edge_latency_structured_single_tile",
            (x_i, x_j, mass, a, corr, out),
            (B, E, V, R, E * V, E * R, 0 if shared else R * V,
             0 if shared else V, E),
            lambda: roofline.edge_latency_structured_single_tile_terms(
                B, E, V, R, bc))
    return out
