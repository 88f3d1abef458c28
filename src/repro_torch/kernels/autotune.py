"""The block policy of the edge-latency kernels K1 and K2 — the counterpart
of ``repro.kernels.autotune``, which picks the Pallas kernels'
``(block_edges, block_v)`` with a TPU VMEM model.

That model does not transfer: the port's kernels are CUDA C++ with their
tiles fixed by the CTA and the tensor-core instruction shapes.  What a
launch can still choose is each kernel's tunables that leave every output
element's order of summation alone, one template instantiation each
(``csrc/edge_latency.cu``, ``K1_CONFIGS`` / ``K2_CONFIGS``): K1's ring
depth (``stages``, 2–4 stages of three 16 KiB tiles) and raster group
(``group``, the row tiles that share a com tile), K2's edge rows a CTA
(``rows``: its shared-memory mass tile is ``rows · R`` floats, so a large R
leaves only the small row blocks, as a large R exhausts VMEM in the
reference) and u steps a pass (``unroll``).  Every config of a kernel is
bitwise equal to every other, so the policy only decides time.

This module ranks the configs with two analytic models that price what
the kernels run (both share :func:`repro_torch.kernels.edge_latency.
block_geometry` with the wrappers):

  * :func:`smem_bytes` — a CTA's shared memory (the ring for K1, the mass
    tile and partial maxima for K2), at most the 227 KB a CTA can use;
  * :func:`predict_seconds` — a roofline over the card's SMs with wave
    quantization: CTAs per SM (the occupancy calculator on the card, the
    kernels' launch bounds without one), the persistent or one-shot grid's
    waves, and per step the larger of the tensor-core time (K1's three
    TF32 products at ``perf.roofline.PEAK_TF32_TC`` and the stage's own
    work), the latency a ring of ``stages`` hides, and the device-memory
    traffic of the concurrent CTAs with their tile revisits (K1 re-reads
    com's hi/lo split once per row tile, shared by a raster group; K2
    reads each row's x_i and x_j once, at the share of
    ``perf.roofline.HBM_BW`` its streams reach).  Its constants were fitted
    to the card (see below); at the serving shapes it prices the configs
    alike, as the card ran them, and keeps the default.

Decisions persist in a process-wide table keyed by ``(backend, kind, V, E,
R, B-bucket)``, B bucketed to the next power of two as in the reference
and the serving layer.  :func:`get_config` consults the table first; a
miss ranks the candidates analytically and, given a ``timer``, races the
top :data:`EMPIRICAL_TOP_K` on the card.  The table round-trips to JSON
(``version`` 1, existing entries win) through :func:`save_table` /
:func:`load_table`, with the reference's keys and the port's config
fields (``stages``, ``group``, ``rows``, ``unroll``) in place of
``block_edges`` / ``block_v``.  Decisions and chosen configs are exported
through :mod:`repro_torch.obs` (``kernels.autotune.decisions`` by source,
a gauge per config field).  No config is ever replaced by another: an
unknown or infeasible one raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading

import torch

from repro_torch import obs
from repro_torch.kernels import edge_latency as kernels
from repro_torch.perf.roofline import HBM_BW, PEAK_FLOPS, PEAK_TF32_TC

__all__ = ["KernelConfig", "ShapeKey", "DEFAULT_CONFIG", "SMEM_BUDGET_BYTES",
           "candidate_configs", "smem_bytes", "predict_seconds", "rank",
           "get_config", "table_rows", "save_table", "load_table",
           "clear_table", "EMPIRICAL_TOP_K", "DeviceSpec", "device_spec"]

SMEM_BUDGET_BYTES = kernels.SMEM_LIMIT      # 227 KB a CTA can opt in to
EMPIRICAL_TOP_K = 3

# NVIDIA H100 SXM: 132 SMs, 228 KB of shared memory and 2048 threads an SM
H100_SMS = 132
SMEM_PER_SM = 233_472
THREADS_PER_SM = 2048
# the model's card constants beside the roofline's peaks, fitted to
# chip_smoke.py's block_policy phase on an NVIDIA H100 80GB HBM3 at
# 700.00 W (every config timed at the serving shapes): the time K1 spends
# on a 32-deep stage beyond its three TF32 products (the x_j fragments'
# ldmatrix and split, the wait for the stage's wgmma, the running sums:
# 1.55 µs a stage measured against 0.84 of products), the share of HBM_BW
# K2's row streams reach (5.64 GB in 2.9 ms), a wrapper call's host time
# (the checks, allocations and the ctypes call) and a launch; and a
# device-memory round trip under load, which a ring of two stages hid as
# well as four did
K1_STEP_OVERHEAD_S = 0.71e-6
K2_BW_SHARE = 0.58
HOST_S = 40e-6
LAUNCH_S = 4.0e-6
LOAD_LATENCY_S = 1.0e-6
# CTAs an SM holds by the kernels' __launch_bounds__ minimum, what the
# model assumes where it cannot ask the card (K1's ~220 registers a thread
# leave room for one CTA; K2 is held to 128: two)
LAUNCH_BOUND_CTAS = {"dense": 1, "structured": 2}
# K1's 32-deep v stage: three TF32 products of a 128 × 128 tile
_K1_STEP_FLOPS = 3 * 2 * 128 * 128 * kernels.STAGE_V
_K1_TILE_BYTES = 128 * kernels.STAGE_V * 4     # one 16 KiB operand tile


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One launch decision for the edge-latency kernels: K1 reads
    ``stages`` and ``group``, K2 ``rows`` and ``unroll``.  The defaults are
    the kernels' constants (``K1_STAGES``, ``K1_GROUP``, ``S_ROWS``,
    ``S_UNROLL`` in ``csrc/edge_latency.cu``)."""

    stages: int = kernels.DEFAULT_DENSE[0]
    group: int = kernels.DEFAULT_DENSE[1]
    rows: int = kernels.DEFAULT_STRUCTURED[0]
    unroll: int = kernels.DEFAULT_STRUCTURED[1]


DEFAULT_CONFIG = KernelConfig()


@dataclasses.dataclass(frozen=True)
class ShapeKey:
    """Decision-table key: everything the choice may depend on.  B buckets
    to the next power of two (one entry per serving-layer shape bucket)."""

    backend: str
    kind: str          # "dense" | "structured"
    V: int
    E: int
    R: int | None
    b_bucket: int

    @classmethod
    def of(cls, backend: str, kind: str, B: int, E: int, V: int,
           R: int | None) -> "ShapeKey":
        return cls(backend=backend, kind=kind, V=int(V), E=int(E),
                   R=None if R is None else int(R),
                   b_bucket=1 << max(int(B) - 1, 0).bit_length())


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """What the model reads of the card: its SMs and, per instantiation,
    the CTAs an SM holds (``occupancy(kind, config, R)``)."""

    sms: int = H100_SMS
    live: bool = False         # True: occupancy from the card itself

    def occupancy(self, kind: str, config: KernelConfig,
                  R: int | None) -> int:
        if self.live:
            return _card_occupancy(kind, _pair(kind, config), R)
        g = kernels.block_geometry(kind, 1, 1, R, config)
        by_smem = SMEM_PER_SM // (g.smem + 1024)   # 1 KB reserved a CTA
        return max(1, min(LAUNCH_BOUND_CTAS[kind], by_smem,
                          THREADS_PER_SM // kernels.THREADS))


_lock = threading.Lock()
_table: dict[ShapeKey, tuple[KernelConfig, str]] = {}
_occupancy: dict[tuple, int] = {}


def _card_occupancy(kind: str, pair: tuple, R: int | None) -> int:
    key = (torch.cuda.current_device(), kind, pair,
           R if kind == "structured" else None)
    with _lock:
        hit = _occupancy.get(key)
    if hit is None:
        hit = kernels.ctas_per_sm(kind, KernelConfig(*_as_fields(kind, pair)),
                                  R)
        with _lock:
            _occupancy[key] = hit
    return hit


def device_spec(backend: str = "cuda") -> DeviceSpec:
    """The current card's SMs and live occupancy when ``backend`` is
    "cuda" and a card is present; else the H100 SXM's 132 SMs and the
    launch bounds."""
    if backend == "cuda" and torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return DeviceSpec(sms=props.multi_processor_count, live=True)
    return DeviceSpec()


def _pair(kind: str, config: KernelConfig) -> tuple[int, int]:
    return (config.stages, config.group) if kind == "dense" \
        else (config.rows, config.unroll)


def _as_fields(kind: str, pair) -> tuple[int, int, int, int]:
    d = DEFAULT_CONFIG
    return (*pair, d.rows, d.unroll) if kind == "dense" \
        else (d.stages, d.group, *pair)


def smem_bytes(kind: str, E: int, V: int, R: int | None,
               config: KernelConfig) -> int:
    """Shared memory of one CTA under ``config``: K1's ring of ``stages``
    stages of three 16 KiB tiles (+ alignment); K2's ``rows · R`` floats of
    mass and its (8, rows) partial maxima.  Raises ValueError for a K2
    config over the 227 KB a CTA can use."""
    return kernels.block_geometry(kind, E, V, R, config).smem


def _waves(n: int, slots: int, wave_s) -> float:
    """Time of ``n`` equal CTAs over ``slots`` concurrent ones: the full
    waves, then the last partial wave, each priced by ``wave_s(ctas)``."""
    full, tail = divmod(n, slots)
    return full * wave_s(slots) + (wave_s(tail) if tail else 0.0)


def predict_seconds(kind: str, B: int, E: int, V: int, R: int | None,
                    config: KernelConfig, com_batch: int = 1,
                    backend: str = "cuda",
                    spec: DeviceSpec | None = None) -> float:
    """Analytic time of one call of K1 (``kind="dense"``) or K2 under
    ``config`` (see the module docstring), on ``spec`` (default: the
    current card, or the H100 SXM without one)."""
    spec = spec or device_spec(backend)
    g = kernels.block_geometry(kind, E, V, R, config, B=B,
                               com_batch=com_batch)
    slots = spec.sms * spec.occupancy(kind, config, R)
    if kind == "dense":
        grid = min(g.tiles, slots)
        per_sm = max(1, grid // spec.sms)
        # one v stage of the concurrent tiles: the tensor cores and the
        # stage's own work, the latency the ring hides, and the bytes the
        # card fetches for it (a raster group of G row tiles shares each
        # com tile; its u tiles share each x_j tile)
        compute = _K1_STEP_FLOPS / (PEAK_TF32_TC / spec.sms / per_sm) \
            + K1_STEP_OVERHEAD_S
        latency = LOAD_LATENCY_S / (config.stages - 1)
        u_conc = min(g.n_ut, -(-grid // g.group))
        dram = (g.group * _K1_TILE_BYTES + 2 * u_conc * _K1_TILE_BYTES) \
            / HBM_BW
        body = math.ceil(g.tiles / grid) * g.nk * max(compute, latency,
                                                      dram)
        split = 3 * 4 * com_batch * V * V / HBM_BW    # com read, hi + lo
        finish = 4 * g.n_batch * g.rows * (g.n_ut + 1) / HBM_BW
        return body + split + finish + 3 * LAUNCH_S + HOST_S
    # K2: each CTA streams its rows' x_i and x_j from device memory once at
    # the share of the bandwidth its streams reach, and waits one round
    # trip per pass of `unroll` u steps
    rows = g.n_batch * g.rows / g.tiles
    dram = 2 * 4 * rows * V
    flops = 2.0 * R * rows * V
    passes = math.ceil(V / (kernels.THREADS * g.unroll))

    def wave_s(n: int) -> float:
        return max(n * dram / (HBM_BW * K2_BW_SHARE), n * flops / PEAK_FLOPS,
                   passes * LOAD_LATENCY_S)

    return _waves(g.tiles, slots, wave_s) + LAUNCH_S + HOST_S


def candidate_configs(kind: str, E: int, V: int, R: int | None,
                      B: int = 1, com_batch: int = 1) -> list[KernelConfig]:
    """The instantiated configs of ``kind`` that fit 227 KB of shared
    memory at this R, deduplicated by the geometry they clamp to (a raster
    group larger than the row tiles runs as the row tiles; an unroll past
    the u steps V needs runs as those steps).  Raises ValueError when none
    fits — there is no smaller kernel to fall back to."""
    pairs = kernels.DENSE_CONFIGS if kind == "dense" \
        else kernels.STRUCTURED_CONFIGS
    out, seen = [], set()
    for pair in pairs:
        cfg = KernelConfig(*_as_fields(kind, pair))
        try:
            g = kernels.block_geometry(kind, E, V, R, cfg, B=B,
                                       com_batch=com_batch)
        except ValueError:
            continue                        # over 227 KB at this R
        eff = (cfg.stages, g.group) if kind == "dense" \
            else (cfg.rows, g.unroll)
        if eff in seen:
            continue
        seen.add(eff)
        out.append(cfg)
    if not out:
        raise ValueError(f"no {kind} instantiation fits {SMEM_BUDGET_BYTES} "
                         f"bytes of shared memory at R={R}")
    return out


def rank(kind: str, B: int, E: int, V: int, R: int | None = None,
         com_batch: int = 1, backend: str = "cuda",
         spec: DeviceSpec | None = None) -> list[KernelConfig]:
    """Feasible candidates, best predicted first (deterministic: ties keep
    the instantiation list's order, the default first)."""
    spec = spec or device_spec(backend)
    cands = candidate_configs(kind, E, V, R, B=B, com_batch=com_batch)
    order = {c: i for i, c in enumerate(cands)}
    return sorted(cands, key=lambda c: (predict_seconds(
        kind, B, E, V, R, c, com_batch=com_batch, backend=backend,
        spec=spec), order[c]))


def get_config(kind: str, B: int, E: int, V: int, R: int | None = None,
               com_batch: int = 1, backend: str | None = None,
               timer=None) -> KernelConfig:
    """The config for one shape: decision-table hit, else the analytic
    ranking (plus a race over the top :data:`EMPIRICAL_TOP_K` when
    ``timer`` — a ``callable(KernelConfig) -> seconds`` on the card — is
    given), stored.  ``backend`` None is "cuda" with a card, else "cpu".
    Pure host work but for the race."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    key = ShapeKey.of(backend, kind, B, E, V, R)
    with _lock:
        hit = _table.get(key)
    reg = obs.registry()
    if hit is not None:
        if reg.enabled:
            reg.counter("kernels.autotune.decisions", kind=kind,
                        source="table", backend=backend).add(1)
        return hit[0]
    cb = 1 if com_batch == 1 else key.b_bucket
    ranked = rank(kind, key.b_bucket, E, V, R, com_batch=cb, backend=backend)
    best, source = ranked[0], "analytic"
    if timer is not None:
        timed = [(timer(c), i, c)
                 for i, c in enumerate(ranked[:EMPIRICAL_TOP_K])]
        best, source = min(timed)[2], "empirical"
    with _lock:
        _table[key] = (best, source)
    if reg.enabled:
        reg.counter("kernels.autotune.decisions", kind=kind, source=source,
                    backend=backend).add(1)
        fields = ("stages", "group") if kind == "dense" else ("rows",
                                                              "unroll")
        for f in fields:
            reg.gauge(f"kernels.autotune.{f}", kind=kind,
                      V=str(V)).set(getattr(best, f))
    return best


# -- decision-table persistence ----------------------------------------------

_FIELDS = ("stages", "group", "rows", "unroll")


def table_rows() -> list[dict]:
    """The decision table as JSON-ready rows: the reference's keys, the
    port's config fields."""
    with _lock:
        items = sorted(_table.items(),
                       key=lambda kv: (kv[0].backend, kv[0].kind, kv[0].V,
                                       kv[0].E, kv[0].b_bucket))
    return [{"backend": k.backend, "kind": k.kind, "V": k.V, "E": k.E,
             "R": k.R, "b_bucket": k.b_bucket,
             **{f: getattr(cfg, f) for f in _FIELDS}, "source": source}
            for k, (cfg, source) in items]


def save_table(path) -> None:
    rows = table_rows()
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": rows}, f, indent=2)


def load_table(path) -> int:
    """Merge a saved decision table into the process table (existing
    entries win — a live decision is never clobbered by a stale file).
    Returns the number of entries loaded.  A config with no instantiation
    raises ValueError: the table is never quietly corrected."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != 1:
        raise ValueError(f"unknown autotune table version "
                         f"{doc.get('version')!r}")
    loaded = 0
    with _lock:
        for row in doc["entries"]:
            key = ShapeKey(backend=row["backend"], kind=row["kind"],
                           V=int(row["V"]), E=int(row["E"]),
                           R=None if row["R"] is None else int(row["R"]),
                           b_bucket=int(row["b_bucket"]))
            if key in _table:
                continue
            cfg = KernelConfig(**{f: int(row[f]) for f in _FIELDS})
            if key.kind == "dense":
                kernels.dense_config(cfg)
            else:
                kernels.structured_config(cfg)
            _table[key] = (cfg, row.get("source", "table"))
            loaded += 1
    return loaded


def clear_table() -> None:
    with _lock:
        _table.clear()
