"""Streaming execution engine: runs a StreamGraph over a device fleet
according to a fractional Placement (paper §3 made executable) — the port
of ``repro.streaming.engine``.

Each batch flows source→sinks; every operator's rows are split across its
devices by ``x_{i,u}``, processed per-device (with per-device speed
modifiers so heterogeneity/stragglers are *felt*, not just modeled), and
re-partitioned along each edge.  The engine reports BOTH:

  * modeled latency — the paper's cost model on the current fleet state,
  * observed per-device busy time — fed back into the straggler monitor,
    which degrades the fleet and re-optimizes placement (runtime loop).

The engine is also the WORLD of the closed adaptive loop
(:mod:`repro.adapt`): trace events mutate its true fleet state
(``degrade`` / ``remove`` / region-level ``outage`` / ``recover``) and its
true operator behavior (``drift`` — runtime selectivity drift the cost
model does NOT see), while an external controller watches only the
observations and decides when to recalibrate and re-place.  For that loop
the event hooks accept ``reoptimize=False`` (the controller, not the
engine, owns placement) and ``observed="work"`` makes busy accounting
deterministic (work-model seconds instead of wall time), so controller
decisions are reproducible under a fixed seed.

Re-optimization runs :func:`repro_torch.core.optimizers.greedy_transfer` on
the compute-extension model (``include_compute=True``), as the reference
does; that problem takes the search engine's scalar float64 loop, so it
needs no card and the re-optimized placement equals the reference's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.costmodel import CostConfig, edge_latencies, latency
from repro_torch.core.devices import ExplicitFleet, RegionFleet
from repro_torch.core.graph import OpGraph
from repro_torch.core.optimizers import PlacementProblem, greedy_transfer
from repro_torch.streaming.operators import StreamGraph

__all__ = ["StreamingEngine", "BatchReport"]

# seconds of simulated busy time per (work unit × row) at unit speed when
# observed="work" — an arbitrary physical unit the calibration loop re-fits
# from observation anyway (the reference's calibration refit)
WORK_SECONDS_PER_ROW = 1e-6


@dataclasses.dataclass
class BatchReport:
    modeled_latency: float
    edge_latencies: np.ndarray
    device_busy: np.ndarray  # observed seconds per device
    rows_in: int
    rows_out: dict
    wall_s: float
    # the WORLD's end-to-end latency: the cost model on the current fleet
    # with the DRIFTED selectivities (true_graph).  Equal to modeled_latency
    # until a "drift" event lands; this is the signal an external observer
    # would measure, and what the adaptive controller watches — the stale
    # modeled_latency above is what the engine's own nominal model believes
    true_latency: float = 0.0
    # per-operator row counters — observables any real runtime has, and the
    # closed loop's calibration inputs: inputs drive the busy/occupancy
    # refit exactly (no nominal-selectivity bias), outputs/inputs IS the
    # operator's true selectivity this tick (drift included)
    op_rows_in: np.ndarray | None = None   # (n_ops,)
    op_rows_out: np.ndarray | None = None  # (n_ops,)


class StreamingEngine:
    def __init__(self, graph: StreamGraph, fleet, placement: np.ndarray,
                 alpha: float = 0.0, device_speed: np.ndarray | None = None,
                 observed: str = "wall"):
        self.graph = graph
        self.fleet = fleet
        self.x = np.asarray(placement, dtype=np.float64)
        self.cfg = CostConfig(alpha=alpha)
        n = fleet.n_devices
        # default to the fleet's own effective speeds: the simulated compute
        # behavior then matches the fleet description the cost model prices
        # (a heterogeneous fleet whose devices all ran at speed 1 would make
        # every observation contradict the model from tick 0)
        self.device_speed = (
            np.asarray(fleet.effective_speed(), dtype=np.float64).copy()
            if device_speed is None
            else np.asarray(device_speed, float))
        self.observed_busy = np.zeros(n)
        if observed not in ("wall", "work"):
            raise ValueError(f"observed must be 'wall' or 'work', "
                             f"got {observed!r}")
        self.observed = observed
        # runtime selectivity multipliers: the TRUE per-op behavior drifts
        # away from the cost-model metadata (sel_scale ≠ 1 ⇒ the model is
        # stale until someone recalibrates) — see apply_event("drift")
        self.sel_scale = np.ones(graph.meta.n_ops)

    # ------------------------------------------------------------ running --
    def _split_rows(self, rows: np.ndarray, fractions: np.ndarray):
        """Deterministic proportional row split across devices."""
        n = len(rows)
        counts = np.floor(fractions * n).astype(int)
        rem = n - counts.sum()
        if rem > 0:
            order = np.argsort(-(fractions * n - counts))
            counts[order[:rem]] += 1
        out, start = {}, 0
        for u, c in enumerate(counts):
            if c > 0:
                out[u] = rows[start:start + c]
                start += c
        return out

    def _apply_sel_scale(self, out: np.ndarray, i: int) -> np.ndarray:
        """Resample operator i's output rows to its drifted TRUE selectivity
        (sel_scale·s_i): truncate when drifted down, repeat rows when drifted
        up.  sel_scale == 1 is exactly a no-op."""
        scale = self.sel_scale[i]
        if scale == 1.0 or len(out) == 0:
            return out
        target = max(int(round(len(out) * scale)), 0)
        if target <= len(out):
            return out[:target]
        reps = -(-target // len(out))  # ceil
        return np.concatenate([out] * reps, axis=0)[:target]

    def run_batch(self, batch: np.ndarray) -> BatchReport:
        with obs.span("engine.run_batch", rows=len(batch)):
            report = self._run_batch(batch)
        reg = obs.registry()
        if reg.enabled:
            reg.counter("engine.batches").add(1)
            reg.counter("engine.rows_in").add(report.rows_in)
            # the WORLD's end-to-end latency signal, as a Perfetto counter
            # timeline — what an adaptive controller watches
            obs.counter_sample("engine.true_latency", report.true_latency)
        return report

    def _run_batch(self, batch: np.ndarray) -> BatchReport:
        t0 = time.perf_counter()
        g = self.graph
        busy = np.zeros(self.fleet.n_devices)
        outputs: dict[int, np.ndarray] = {}
        rows_out: dict[str, int] = {}
        op_in = np.zeros(g.meta.n_ops)
        op_out = np.zeros(g.meta.n_ops)
        for i in g.meta.topo_order:
            op = g.ops[i]
            if not g.meta.predecessors(i):
                rows = batch
            else:
                parts = [outputs[p] for p in g.meta.predecessors(i)]
                rows = np.concatenate(parts, axis=0) if len(parts) > 1 \
                    else parts[0]
            shards = self._split_rows(rows, self.x[i])
            processed = []
            for u, shard in shards.items():
                t1 = time.perf_counter()
                processed.append(op.fn(shard))
                if self.observed == "work":
                    # deterministic observation: work-model seconds (the
                    # simulated world's ground truth, reproducible across
                    # runs — wall time of tiny numpy calls is not)
                    dt = op.work * len(shard) * WORK_SECONDS_PER_ROW \
                        / self.device_speed[u]
                else:
                    dt = (time.perf_counter() - t1) / self.device_speed[u]
                busy[u] += dt
            out = (np.concatenate(processed, axis=0) if processed
                   else rows[:0])
            out = self._apply_sel_scale(out, i)
            outputs[i] = out
            op_in[i] = len(rows)
            op_out[i] = len(out)
            if not g.meta.successors(i):
                rows_out[op.name] = len(out)
        self.observed_busy = 0.8 * self.observed_busy + 0.2 * busy
        elat = edge_latencies(g.meta, self.fleet, self.x, self.cfg)
        lat = latency(g.meta, self.fleet, self.x, self.cfg)
        tlat = lat if np.all(self.sel_scale == 1.0) else \
            latency(self.true_graph(), self.fleet, self.x, self.cfg)
        return BatchReport(lat, elat, busy, len(batch), rows_out,
                           time.perf_counter() - t0, true_latency=tlat,
                           op_rows_in=op_in, op_rows_out=op_out)

    # ------------------------------------------------------- trace hooks --
    def apply_event(self, kind: str, device: int, factor: float = 1.0,
                    beta: float = 0.0, reoptimize: bool = True):
        """Uniform entry point for replayed trace events (repro.sim.replay):

          * ``degrade``  → degrade_and_replace (``device`` indexes the
            CURRENT fleet),
          * ``remove``   → remove_device,
          * ``outage``   → every current device of REGION ``device`` is
            degraded by ``factor`` (time-correlated whole-region failure;
            paired with a later ``recover``),
          * ``recover``  → the region's devices degraded by ``1/factor``
            (the outage lifts),
          * ``drift``    → operator ``device``'s TRUE selectivity is scaled
            by ``factor`` (the cost-model metadata is left stale — this is
            the drift an adaptive controller exists to chase).

        ``reoptimize=False`` applies the fleet mutation without re-running
        the placement optimizer (placement is remapped mechanically on
        removals) — the mode the reference's adaptive controller uses,
        since the controller owns the re-optimization decision.
        """
        if kind == "degrade":
            return self.degrade_and_replace(device, factor, beta=beta,
                                            reoptimize=reoptimize)
        if kind == "remove":
            return self.remove_device(device, beta=beta,
                                      reoptimize=reoptimize)
        if kind in ("outage", "recover"):
            f = factor if kind == "outage" else 1.0 / factor
            region = np.asarray(self.fleet.region)
            hit = np.flatnonzero(region == device)
            if not hit.size:
                return None
            # the whole region in one pass over the com matrix, then one
            # optimizer pass at most — regions can be wide
            self._degrade(hit, f)
            return self._replace(beta) if reoptimize else None
        if kind == "drift":
            self.sel_scale[device] *= factor
            return None
        raise ValueError(f"unknown event kind {kind!r}")

    def true_graph(self) -> OpGraph:
        """The WORLD's operator graph: cost-model metadata with the drifted
        runtime selectivities folded in (``s_i·sel_scale_i``).  This is what
        an omniscient oracle prices; the engine's own ``modeled_latency``
        keeps using the stale nominal graph, exactly like the controller's
        belief does."""
        meta = self.graph.meta
        if np.all(self.sel_scale == 1.0):
            return meta
        ops = [dataclasses.replace(
            op, selectivity=float(op.selectivity * self.sel_scale[i]))
            for i, op in enumerate(meta.operators)]
        return OpGraph(ops, list(meta.edges))

    # ------------------------------------------------- straggler handling --
    def degrade_and_replace(self, device: int, factor: float,
                            beta: float = 0.0, reoptimize: bool = True):
        """Straggler mitigation: fold the observed slowdown into the fleet,
        re-run the placement optimizer, adopt the new x (the paper's
        heterogeneity terms used as live state).  ``reoptimize=False`` only
        mutates the fleet/speed state."""
        self._degrade(np.array([device]), factor)
        return self._replace(beta) if reoptimize else None

    def _degrade(self, devices: np.ndarray, factor: float) -> None:
        """Degrade ``devices`` (distinct ids) by ``factor``: their links
        ``factor``× slower (× factor² between two of them), the self-cost
        diagonal kept, their speeds divided.  Bitwise the fleet that
        ``ExplicitFleet.degrade_device`` gives applied to each device in
        turn, as the reference does — a pair of degraded devices takes
        its two factors one after the other — but with one copy of the com
        matrix instead of one per device."""
        self._materialize()
        com = self.fleet.com_cost
        c = com.copy()
        c[devices, :] *= factor
        c[:, devices] *= factor
        np.fill_diagonal(c, np.diag(com))
        speed = self.fleet.speed.copy()
        speed[devices] /= factor
        self.fleet = dataclasses.replace(self.fleet, com_cost=c, speed=speed)
        self.device_speed[devices] /= factor

    def _replace(self, beta: float):
        """Re-optimize the placement on the current fleet from the current
        x (greedy on the compute-extension problem) and adopt it."""
        prob = PlacementProblem(self.graph.meta, self.fleet,
                                CostConfig(alpha=self.cfg.alpha,
                                           include_compute=True), beta=beta)
        res = greedy_transfer(prob, x0=self.x)
        self.x = res.x
        return res

    def remove_device(self, device: int, beta: float = 0.0,
                      reoptimize: bool = True):
        """Elastic down-scale after a device loss: rebuild the fleet without
        it, re-optimize, remap fractions (column deleted, rows renormalized
        as a warm start).  ``reoptimize=False`` keeps the renormalized
        warm-start placement as-is."""
        self._materialize()
        self.fleet, keep = self.fleet.without_devices([device])
        x0 = self.x[:, keep]
        self.x = x0 / np.maximum(x0.sum(axis=1, keepdims=True), 1e-9)
        self.device_speed = self.device_speed[keep]
        self.observed_busy = self.observed_busy[keep]
        return self._replace(beta) if reoptimize else None

    def _materialize(self) -> None:
        """A RegionFleet becomes the ExplicitFleet it describes before a
        per-device mutation."""
        if isinstance(self.fleet, RegionFleet):
            self.fleet = ExplicitFleet(com_cost=self.fleet.com_matrix(),
                                       speed=self.fleet.effective_speed(),
                                       available=self.fleet.available,
                                       region=self.fleet.region)
