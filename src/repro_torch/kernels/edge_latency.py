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

K1 and K2 take a launch config (``config=``, an object with ``stages`` and
``group`` for K1, ``rows`` and ``unroll`` for K2, as
:class:`repro_torch.kernels.autotune.KernelConfig`); None is the default,
the constants the kernels were written with.  Each config is one
instantiation of the kernel's template (:data:`DENSE_CONFIGS`,
:data:`STRUCTURED_CONFIGS`, the lists
``K1_CONFIGS`` / ``K2_CONFIGS`` of ``csrc/edge_latency.cu``), and every one
is bitwise equal to every other: a config changes the tiling, never an
element's order of summation.  Any other config raises before a launch.
:func:`block_geometry` is the single source of the padded rows, tiles and
shared memory of a launch, for the wrappers and for the block policy
alike; :data:`last_launch` records the tiles and CTAs the launcher
reported, and :func:`ctas_per_sm` asks the card how many CTAs of an
instantiation fit on one SM.

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
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.perf import counts, roofline

__all__ = ["KERNELS", "launches", "reset_launches", "edge_latency_dense",
           "edge_latency_structured", "edge_latency_dense_single_tile",
           "edge_latency_structured_single_tile", "SMEM_LIMIT",
           "single_tile_smem_bytes", "single_tile_max_v",
           "check_single_tile", "DENSE_CONFIGS", "STRUCTURED_CONFIGS",
           "BlockGeometry", "block_geometry", "dense_config",
           "structured_config", "last_launch", "ctas_per_sm"]

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

# csrc/edge_latency.cu's tiles: K1's CTA tile (K1_BM rows × K1_BN u), its
# 32-deep v stages (STAGE_V), one stage's three 16 KiB tiles (x_j, com_hi,
# com_lo) and the ring's alignment slack; both kernels' threads a CTA
DENSE_TILE_ROWS, STAGE_V, DENSE_STAGE_BYTES, DENSE_SMEM_SLACK = \
    128, 32, 3 * 128 * 128, 1024
THREADS = 256
# the instantiations of K1 (stages, group) and K2 (rows, unroll): the
# lists K1_CONFIGS and K2_CONFIGS of csrc/edge_latency.cu, default first
DENSE_CONFIGS = ((4, 8), (4, 16), (4, 4), (3, 8), (3, 16), (2, 8))
STRUCTURED_CONFIGS = ((8, 4), (8, 2), (8, 8), (4, 4), (4, 8))
DEFAULT_DENSE, DEFAULT_STRUCTURED = DENSE_CONFIGS[0], STRUCTURED_CONFIGS[0]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_INFO = ctypes.POINTER(ctypes.c_int64)
_bound: ctypes.CDLL | None = None
# the tiles and CTAs the last K1 / K2 launch reported, by kernel name
last_launch: dict[str, dict[str, int]] = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("edge_latency")
        lib.edge_latency_dense_launch.argtypes = \
            [_P] * 7 + [_I] * 11 + [_INFO, _P]
        lib.edge_latency_dense_launch.restype = ctypes.c_int
        lib.edge_latency_structured_launch.argtypes = \
            [_P] * 6 + [_I] * 14 + [_INFO, _P]
        lib.edge_latency_structured_launch.restype = ctypes.c_int
        lib.edge_latency_ctas_per_sm.argtypes = [_I] * 4 + [_INFO]
        lib.edge_latency_ctas_per_sm.restype = ctypes.c_int
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


def _launch(name: str, tensors: tuple, ints: tuple, terms,
            info: bool = False) -> None:
    """Call ``<name>_launch`` with the tensors' pointers, the integer
    shape/stride arguments (then, with ``info``, a buffer the launcher
    fills with its tiles and CTAs, kept in :data:`last_launch`) and the
    current stream; count the launch and report ``terms()`` (its roofline
    terms) to an open counter."""
    lib = _lib()
    dev = tensors[0].device
    buf = (ctypes.c_int64 * 2)()
    with torch.cuda.device(dev):     # launch on the operands' card
        rc = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in tensors), *ints, *((buf,) if info else ()),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.edge_latency_error_string(rc).decode()}")
    if info:
        last_launch[name] = {"tiles": buf[0], "ctas": buf[1]}
    launches[name] += 1
    if counts.ACTIVE:
        counts.report_kernel(name, terms())


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """How one (E, V[, R]) launch of K1 or K2 is laid out under a config.

    This is THE single source of truth for the launch: the wrappers launch
    exactly by it and the block policy
    (:mod:`repro_torch.kernels.autotune`) prices exactly it, so the model
    can never drift from the kernel; the launcher's own count of tiles is
    held against :attr:`tiles` on the card."""

    kind: str          # "dense" (K1) | "structured" (K2)
    n_batch: int       # launch batches (1 when the scenario is shared)
    rows: int          # edge rows a batch (B·E when the scenario is shared)
    row_tile: int      # rows a CTA tile: K1_BM, or K2's rows
    n_rt: int          # row tiles a batch
    n_ut: int          # K1's 128-wide u tiles (1 for K2)
    nk: int            # K1's 32-deep v stages (0 for K2)
    tiles: int         # K1's persistent-grid tiles; K2's CTAs
    smem: int          # shared memory a CTA, bytes (dynamic + static)
    group: int         # K1's raster group, clamped to the row tiles
    unroll: int        # K2's u steps a pass, clamped to the steps V needs


def dense_config(config) -> tuple[int, int]:
    """K1's (stages, group) for ``config`` (None: the default); raises
    ValueError for a pair with no instantiation."""
    if config is None:
        return DEFAULT_DENSE
    pair = (int(config.stages), int(config.group))
    if pair not in DENSE_CONFIGS:
        raise ValueError(f"K1 has no instantiation for (stages, group) = "
                         f"{pair}; built: {DENSE_CONFIGS}")
    return pair


def structured_config(config) -> tuple[int, int]:
    """K2's (rows, unroll) for ``config`` (None: the default); raises
    ValueError for a pair with no instantiation."""
    if config is None:
        return DEFAULT_STRUCTURED
    pair = (int(config.rows), int(config.unroll))
    if pair not in STRUCTURED_CONFIGS:
        raise ValueError(f"K2 has no instantiation for (rows, unroll) = "
                         f"{pair}; built: {STRUCTURED_CONFIGS}")
    return pair


def block_geometry(kind: str, E: int, V: int, R: int | None, config=None,
                   B: int = 1, com_batch: int = 1) -> BlockGeometry:
    """The launch of K1 (``kind="dense"``) or K2 (``"structured"``) for B
    batches of (E, V) edge rows against ``com_batch`` scenarios (1 shares
    one: the rows are flattened into one batch) under ``config`` (None: the
    default).  Raises ValueError for an unknown kind or config, a bad shape,
    and a K2 config whose (rows, R) mass tile exceeds the 227 KB a CTA can
    use."""
    if kind not in ("dense", "structured"):
        raise ValueError(f"kind must be dense|structured, got {kind!r}")
    if E < 1 or V < 1 or B < 1:
        raise ValueError(f"need B, E, V >= 1, got B={B}, E={E}, V={V}")
    if com_batch not in (1, B):
        raise ValueError(f"scenario batch {com_batch} must be 1 or {B}")
    n_batch, rows = (1, B * E) if com_batch == 1 else (B, E)
    if kind == "dense":
        stages, group = dense_config(config)
        n_rt = -(-rows // DENSE_TILE_ROWS)
        n_ut = -(-V // DENSE_TILE_U)
        return BlockGeometry(
            kind, n_batch, rows, DENSE_TILE_ROWS, n_rt, n_ut,
            -(-V // STAGE_V), n_batch * n_rt * n_ut,
            stages * DENSE_STAGE_BYTES + DENSE_SMEM_SLACK, min(group, n_rt),
            0)
    if R is None or R < 1:
        raise ValueError(f"structured geometry needs R >= 1, got {R}")
    row_tile, unroll = structured_config(config)
    smem = 4 * row_tile * R + 4 * (THREADS // 32) * row_tile
    if smem > SMEM_LIMIT:
        raise ValueError(f"K2 at {row_tile} rows a CTA needs {smem} bytes of "
                         f"shared memory at R={R}, over the {SMEM_LIMIT} a "
                         f"CTA can use")
    n_rt = -(-rows // row_tile)
    return BlockGeometry(kind, n_batch, rows, row_tile, n_rt, 1, 0,
                         n_batch * n_rt, smem, 0,
                         min(unroll, -(-V // THREADS)))


def ctas_per_sm(kind: str, config=None, R: int | None = None) -> int:
    """CTAs of K1's or K2's instantiation for ``config`` that fit on one SM
    of the current card (the occupancy calculator: registers and shared
    memory; K2's depends on R).  Needs the card and the built library."""
    pair = dense_config(config) if kind == "dense" \
        else structured_config(config)
    out = ctypes.c_int64(0)
    lib = _lib()
    rc = lib.edge_latency_ctas_per_sm(0 if kind == "dense" else 1, *pair,
                                      int(R or 0), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"occupancy of {kind} {pair} failed: "
                           f"{lib.edge_latency_error_string(rc).decode()}")
    return int(out.value)


def edge_latency_dense(x_i: torch.Tensor, x_j: torch.Tensor,
                       com: torch.Tensor, config=None) -> torch.Tensor:
    """K1: x_i, x_j (B, E, V) with selectivity folded into x_i; com
    (B, V, V) or (1, V, V) → (B, E) ``max_u x_i·(com @ x_j)_u``, launched
    at ``config``'s instantiation (None: the default).  A shared com (batch
    1) is read with batch stride 0 and the (B, E) rows are flattened into
    one row axis, so it is never replicated."""
    B, E, V = x_i.shape
    dev = x_i.device
    bc = com.shape[0]
    if bc not in (1, B):
        raise ValueError(f"com batch dim {bc} must be 1 or {B}")
    for name, t, shape in (("x_i", x_i, (B, E, V)), ("x_j", x_j, (B, E, V)),
                           ("com", com, (bc, V, V))):
        _check(name, t, shape, dev)
    stages, group = dense_config(config)
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    g = block_geometry("dense", E, V, None, config, B=B, com_batch=bc)
    com_hi, com_lo = torch.empty_like(com), torch.empty_like(com)
    partial = torch.empty((g.n_batch, g.n_ut, g.rows),
                          dtype=torch.float32, device=dev)
    _launch("edge_latency_dense",
            (x_i, x_j, com, com_hi, com_lo, partial, out),
            (g.n_batch, g.rows, V, E * V, V, 0 if bc == 1 else V * V, V, E,
             com.numel(), stages, group),
            lambda: roofline.edge_latency_dense_terms(B, E, V, bc),
            info=True)
    return out


def edge_latency_structured(x_i: torch.Tensor, x_j: torch.Tensor,
                            mass: torch.Tensor, a: torch.Tensor,
                            corr: torch.Tensor, config=None) -> torch.Tensor:
    """K2: x_i, x_j (B, E, V); mass (B, E, R); a (Bc, R, V); corr
    (Bc, 1, V), Bc ∈ {1, B} → (B, E) ``max_u x_i·(mass @ a + corr·x_j)``,
    launched at ``config``'s instantiation (None: the default).  A shared
    scenario (Bc = 1) is read with batch stride 0."""
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
    rows_per_cta, unroll = structured_config(config)
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    g = block_geometry("structured", E, V, R, config, B=B, com_batch=bc)
    shared = bc == 1
    _launch("edge_latency_structured", (x_i, x_j, mass, a, corr, out),
            (g.n_batch, g.rows, V, R, E * V, V, E * R, R,
             0 if shared else R * V, V, 0 if shared else V, E, rows_per_cta,
             unroll),
            lambda: roofline.edge_latency_structured_single_tile_terms(
                B, E, V, R, bc),    # K2's function
            info=True)
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
