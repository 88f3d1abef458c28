"""`WhatIfService` on PyTorch — the single-host, multi-tenant what-if
serving loop of ``repro.serve.service``, ported.

Query lifecycle::

    submit ── normalize ── bucket ── admit ─┬─ Rejected (typed, priced)
                                            └─ queue[CoalesceKey]
    step ──── coalesce queues ── pad to 2^k ── ONE raw score_grid per chunk
                 └── per-query analytic dq/β finish ── stream ResultChunks
                                                        └── final QueryResult

Tenants :meth:`~WhatIfService.register_fleet` scenario packs once (content
digest → equal fleets coalesce across tenants), optionally with an
:class:`~repro_torch.core.objectives.ObjectiveSet`, then
:meth:`~WhatIfService.submit` queries — score a placement batch, rank
candidates (weighted or ε-constraint), extract a Pareto front, co-optimize
placement × dq.  The service
prices each query against the p99 budget (:mod:`repro_torch.serve.admission`)
and merges admitted rows across tenants into power-of-two-padded chunks.

Every dispatch is RAW (dq = 0, β = 0) and makes ONE host transfer
(``.cpu()`` on the chunk's grid, or on the objective grids and their
scalarization stacked on the device); per-query dq/β are finished on the
host.  A single-objective score, and every finished per-objective grid,
is bitwise what a direct ``score_grid`` with the same dq/β returns over
the rows as dispatched; a multi-objective score recombines the raw
scalarization on the host (:func:`split_dq_term`), as the reference
does.  A dense pack is moved to the
device once, at registration.  The CUDA kernels are built once when a
service on the card is created and that time is recorded as
``stats.setup_s``, so no dispatch and no admission price ever includes it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.costmodel import CostConfig
from repro_torch.core.devices import RegionFleetFamily
from repro_torch.core.graph import OpGraph
from repro_torch.core.objectives import (ObjectiveGrids, ObjectiveSet,
                                         as_objective_set)
from repro_torch.kernels import build, dispatch
from repro_torch.search.decision import (dq_caps_mask, epsilon_constraint,
                                         joint_dq_scores, pareto_front,
                                         robust_select, split_dq_term)
from repro_torch.serve.admission import (AdmissionConfig, Admitted, Degraded,
                                         DispatchPricer, Rejected, decide)
from repro_torch.serve.bucketing import (CoalesceKey, dq_denominator,
                                         finish_scores, fleet_digest,
                                         next_pow2, pad_rows)
from repro_torch.serve.cache import ServeStats
from repro_torch.sim.batched import BatchedEvaluator

__all__ = ["WhatIfQuery", "QueryTicket", "ResultChunk", "QueryResult",
           "WhatIfService"]

_KINDS = ("score", "rank", "pareto", "joint")


@dataclasses.dataclass(frozen=True)
class WhatIfQuery:
    """One tenant question over a batch of candidate placements.

    ``kind`` picks the post-processing applied to the (scenario, candidate)
    grids the shared dispatch produces — the dispatch itself is identical:

    * ``"score"``  — the finished (S, P) score grid(s), dq/β applied;
    * ``"rank"``   — top-``top_k`` candidates by worst-case score; with
      ``minimize`` (and ``eps_caps``) the ranking is ε-constraint (minimize
      one objective subject to caps on the others) instead of the weighted
      sum;
    * ``"pareto"`` — the non-dominated front over the fleet's objectives
      (requires the fleet to be registered with an ObjectiveSet);
    * ``"joint"``  — placement × dq co-optimization over ``dq_values``
      (optionally DQCoupling-masked), min–max selected.

    ``scenario`` reduces grids across scenarios for pareto and ε-rank:
    ``"worst"`` (the per-objective envelope) or a scenario index.

    ``dq`` may be a scalar or per-scenario (S,) column; dq/β never affect
    which super-batch the query coalesces into.
    """

    kind: str
    placements: np.ndarray
    dq: float | np.ndarray = 0.0
    beta: float = 0.0
    # rank
    top_k: int = 1
    minimize: str | None = None
    eps_caps: dict | None = None
    # pareto / rank reduction across scenarios
    scenario: int | str = "worst"
    # joint
    dq_values: np.ndarray | None = None
    coupling: object | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        x = np.asarray(self.placements, dtype=np.float32)
        if x.ndim != 3:
            raise ValueError(f"placements must be (P, n_ops, V), "
                             f"got {x.shape}")
        object.__setattr__(self, "placements", x)
        if self.kind == "joint" and self.dq_values is None:
            raise ValueError("joint queries need dq_values")
        if self.eps_caps and self.minimize is None:
            raise ValueError("eps_caps needs minimize=<objective name>")


@dataclasses.dataclass(frozen=True)
class QueryTicket:
    """submit()'s receipt: the query id results will carry, plus the typed
    admission verdict (Admitted or Degraded — Rejected never queues)."""

    query_id: int
    tenant: str
    admission: Admitted | Degraded
    rows: int            # candidate rows actually queued (post-degrade)
    dq_steps: int | None


@dataclasses.dataclass(frozen=True)
class ResultChunk:
    """A streamed partial: finished scores for ``rows`` candidates starting
    at ``offset`` within the (possibly degraded) query batch."""

    query_id: int
    tenant: str
    offset: int
    scores: np.ndarray   # (S, rows) finished scalar scores

    @property
    def rows(self) -> int:
        return int(self.scores.shape[1])


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """The final answer for one query (follows its ResultChunks).

    ``scores`` is always the finished (S, P) scalar grid over the rows the
    query actually dispatched.  Kind-specific extras: ``top``/``worst``/
    ``best`` (rank), ``front`` (pareto), ``best``/``dq_idx``/``worst``
    (joint), ``infeasible`` (joint with no feasible (candidate, dq) pair,
    or ε-constraint with no candidate under the caps).  ``grids`` carries
    the finished per-objective (S, P) grids when the fleet was registered
    with an ObjectiveSet."""

    query_id: int
    tenant: str
    kind: str
    scores: np.ndarray
    grids: dict | None = None
    degraded: Degraded | None = None
    top: np.ndarray | None = None
    worst: np.ndarray | None = None
    front: object | None = None
    best: int | None = None
    dq_idx: np.ndarray | None = None
    infeasible: bool = False


@dataclasses.dataclass
class _Fleet:
    pack: object                    # (S, V, V) device tensor or family
    key: CoalesceKey
    n_scenarios: int
    n_devices: int
    objectives: ObjectiveSet | None
    speed: torch.Tensor | None      # dense (S, V) speeds, or None
    pricer: DispatchPricer


@dataclasses.dataclass
class _Pending:
    """An admitted query waiting in (or mid-flight through) its key's
    queue, accumulating raw host-side grid columns chunk by chunk."""

    query_id: int
    tenant: str
    query: WhatIfQuery
    placements: np.ndarray          # post-degrade (P, n_ops, V)
    dq_values: np.ndarray | None    # post-degrade
    predicted_s: float
    degraded: Degraded | None
    done_rows: int = 0
    lat_cols: list = dataclasses.field(default_factory=list)
    rest_cols: list = dataclasses.field(default_factory=list)
    w_lat: float = 1.0
    raw_cols: dict = dataclasses.field(default_factory=dict)

    @property
    def rows(self) -> int:
        return int(self.placements.shape[0])


class WhatIfService:
    """Single-host what-if serving for one operator graph on one device.

    ``device=None`` means the card and raises without CUDA; tests pass
    ``device="cpu"``.  ``max_chunk_rows`` bounds a single dispatch
    (super-batches larger than it stream in chunks); admission is
    configured via :class:`AdmissionConfig`.
    """

    def __init__(self, graph: OpGraph, cfg: CostConfig = CostConfig(),
                 device=None,
                 admission: AdmissionConfig = AdmissionConfig(),
                 max_chunk_rows: int = 1024):
        if max_chunk_rows < 1 or max_chunk_rows & (max_chunk_rows - 1):
            raise ValueError(f"max_chunk_rows must be a power of two, "
                             f"got {max_chunk_rows}")
        self.graph = graph
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.admission = admission
        self.max_chunk_rows = max_chunk_rows
        self._ev = BatchedEvaluator.shared(graph, cfg, device=self.device)
        self._fleets: dict[str, _Fleet] = {}
        self._queues: dict[CoalesceKey, list[_Pending]] = {}
        self._mail: dict[str, list] = {}
        self._next_id = 0
        self.stats = ServeStats()
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            build.load("edge_latency")
            self.stats.setup_s = time.perf_counter() - t0

    # -- registration --------------------------------------------------------
    def register_fleet(self, tenant: str, pack, objectives=None,
                       speed=None) -> str:
        """Register a scenario pack (dense (S, V, V) stack or
        RegionFleetFamily) and get back its fleet id — a content digest,
        so two tenants registering equal fleets receive the SAME id and
        their queries coalesce into one dispatch stream.  ``objectives``
        fixes the multi-objective set for queries against this fleet (None
        = single-objective latency-F); the id then carries the set's hash,
        so two sets on one pack never share a dispatch.  ``speed`` ((V,) or
        (S, V) effective speeds) feeds a dense pack's occupancy objectives,
        as ``score_grid``'s ``speed`` does."""
        obj_set = as_objective_set(objectives) if objectives is not None \
            else None
        structured = isinstance(pack, RegionFleetFamily)
        if speed is not None and obj_set is None:
            raise ValueError("speed only feeds the occupancy objectives "
                             "— pass objectives= to use it")
        if speed is not None and structured:
            raise ValueError("structured families carry their own "
                             "speeds; leave speed=None")
        if isinstance(pack, torch.Tensor):
            pack = pack.detach().cpu().numpy()
        if not structured:
            pack = np.asarray(pack, dtype=np.float32)
        if speed is not None:
            speed = self._ev._dense_speeds(int(pack.shape[0]),
                                           int(pack.shape[1]), speed)
        fid = fleet_digest(pack, None if speed is None
                           else speed.cpu().numpy())
        if obj_set is not None:
            fid = f"{fid}:{abs(hash(obj_set)):x}"
        if fid in self._fleets:
            return fid
        if structured:
            S, V, R = pack.n_scenarios, pack.n_devices, pack.n_regions
        else:
            S, V, R = int(pack.shape[0]), int(pack.shape[1]), None
            pack = torch.tensor(pack, device=self.device)   # a copy
        self._fleets[fid] = _Fleet(
            pack=pack, key=CoalesceKey.of(self.graph, self.cfg, self.device,
                                          fid, obj_set),
            n_scenarios=S, n_devices=V, objectives=obj_set, speed=speed,
            pricer=DispatchPricer(len(self.graph.edges), V, R,
                                  cfg=self.admission))
        return fid

    # -- submission (normalize → bucket → admit → queue) ---------------------
    def submit(self, tenant: str, fleet_id: str,
               query: WhatIfQuery) -> QueryTicket | Rejected:
        """Price the query and either queue it (returning a
        :class:`QueryTicket` whose ``admission`` says what, if anything,
        was degraded) or refuse it with a typed :class:`Rejected` —
        nothing is dispatched here; call :meth:`step` / :meth:`drain`."""
        fleet = self._fleets[fleet_id]
        q = query
        if q.kind == "pareto" and fleet.objectives is None:
            raise ValueError("pareto queries need the fleet registered "
                             "with an ObjectiveSet")
        if (q.eps_caps or q.minimize is not None) \
                and fleet.objectives is None:
            raise ValueError("ε-constraint ranking (minimize/eps_caps) "
                             "needs the fleet registered with an "
                             "ObjectiveSet")
        if q.placements.shape[2] != fleet.n_devices:
            raise ValueError(
                f"placements have V={q.placements.shape[2]} devices; "
                f"fleet {fleet_id} has V={fleet.n_devices}")
        dq_steps = None if q.dq_values is None else len(
            np.atleast_1d(q.dq_values))
        rows = q.placements.shape[0]
        verdict = decide(
            fleet.pricer, fleet.n_scenarios, next_pow2(rows),
            backlog_s=self._backlog_s(), cfg=self.admission,
            dq_steps=dq_steps,
            bucket_stats=self.stats.peek_bucket(next_pow2(rows)))
        reg = obs.registry()
        if isinstance(verdict, Rejected):
            self.stats.rejected += 1
            if reg.enabled:
                reg.counter("serve.admission", verdict="rejected").add(1)
            return verdict
        placements, dq_vals, degraded = q.placements, q.dq_values, None
        if isinstance(verdict, Degraded):
            degraded = verdict
            self.stats.degraded += 1
            placements = placements[:verdict.keep_rows]
            if verdict.dq_steps is not None and dq_steps is not None \
                    and verdict.dq_steps < dq_steps:
                grid = np.atleast_1d(
                    np.asarray(q.dq_values, dtype=np.float64))
                pick = np.linspace(0, len(grid) - 1,
                                   verdict.dq_steps).round().astype(int)
                dq_vals = grid[np.unique(pick)]
        else:
            self.stats.admitted += 1
        if reg.enabled:
            reg.counter("serve.admission",
                        verdict=("degraded" if degraded else
                                 "admitted")).add(1)
        qid = self._next_id
        self._next_id += 1
        self._queues.setdefault(fleet.key, []).append(_Pending(
            query_id=qid, tenant=tenant, query=q, placements=placements,
            dq_values=dq_vals, predicted_s=verdict.predicted_s,
            degraded=degraded))
        return QueryTicket(query_id=qid, tenant=tenant, admission=verdict,
                           rows=placements.shape[0],
                           dq_steps=None if dq_vals is None
                           else len(np.atleast_1d(dq_vals)))

    def _backlog_s(self) -> float:
        return sum(p.predicted_s for queue in self._queues.values()
                   for p in queue)

    # -- the serving loop (coalesce → pad → dispatch → stream) ---------------
    def step(self) -> int:
        """Serve the oldest non-empty coalesce queue: merge its pending
        queries into one super-batch, dispatch it RAW in ≤max_chunk_rows
        power-of-two chunks, stream each chunk's finished scores to tenant
        mailboxes, finalize completed queries.  Returns the number of
        queries completed (0 = nothing pending)."""
        key = next((k for k, queue in self._queues.items() if queue), None)
        if key is None:
            return 0
        queue = self._queues.pop(key)
        fleet = next(f for f in self._fleets.values() if f.key == key)
        batch = np.concatenate([p.placements for p in queue])
        # (query, slice) spans inside the super-batch, in queue order
        spans, off = [], 0
        for p in queue:
            spans.append((p, off, off + p.rows))
            off += p.rows
        done = 0
        for start in range(0, batch.shape[0], self.max_chunk_rows):
            chunk = batch[start:start + self.max_chunk_rows]
            bucket = next_pow2(chunk.shape[0])
            lat, rest, w_lat, raw = self._dispatch(
                fleet, pad_rows(chunk, bucket), bucket,
                n_rows=chunk.shape[0],
                n_queries=sum(1 for _, a, b in spans
                              if a < start + chunk.shape[0] and b > start))
            end = start + chunk.shape[0]
            for p, a, b in spans:
                lo, hi = max(a, start), min(b, end)
                if lo >= hi:
                    continue
                sl = slice(lo - start, hi - start)
                p.lat_cols.append(lat[:, sl])
                p.rest_cols.append(rest[:, sl])
                p.w_lat = w_lat
                for name, g in raw.items():
                    p.raw_cols.setdefault(name, []).append(g[:, sl])
                if p.query.kind != "joint":
                    fin = finish_scores(p.lat_cols[-1], p.rest_cols[-1],
                                        w_lat, p.query.dq, p.query.beta)
                    self._mail.setdefault(p.tenant, []).append(ResultChunk(
                        query_id=p.query_id, tenant=p.tenant,
                        offset=p.done_rows, scores=fin))
                p.done_rows += hi - lo
                if p.done_rows == p.rows:
                    self._mail.setdefault(p.tenant, []).append(
                        self._finalize(fleet, p))
                    done += 1
        return done

    def drain(self) -> int:
        """step() until every queue is empty; returns queries completed."""
        total = 0
        while True:
            n = self.step()
            if n == 0 and not any(self._queues.values()):
                return total
            total += n

    def poll(self, tenant: str) -> list:
        """Drain the tenant's mailbox: ResultChunk / QueryResult, in
        completion order."""
        return self._mail.pop(tenant, [])

    # -- dispatch + accounting ----------------------------------------------
    def _dispatch(self, fleet: _Fleet, padded: np.ndarray, bucket: int,
                  n_rows: int, n_queries: int):
        """ONE raw score_grid call (dq = 0, β = 0) over the padded chunk and
        ONE host transfer; returns host float32 (lat, rest, w_lat, raw
        per-objective grids) with padding rows already sliced off."""
        t0 = time.perf_counter()
        out = self._ev.score_grid(padded, fleet.pack, dq=0.0, beta=0.0,
                                  objectives=fleet.objectives,
                                  speed=fleet.speed)
        if isinstance(out, ObjectiveGrids):
            out = out.to_host()    # grids + scalarized, one transfer
            raw = {n: g[:, :n_rows] for n, g in out.grids.items()}
        else:
            out = out.cpu().numpy()
            raw = {}
        seconds = time.perf_counter() - t0
        lat, rest, w_lat = split_dq_term(out)
        lat = np.asarray(lat, dtype=np.float32)[:, :n_rows]
        rest = np.asarray(rest, dtype=np.float32)[:, :n_rows]
        # eager execution: nothing recompiles, and the kernel build was
        # paid at set-up (stats.setup_s)
        self.stats.bucket(bucket).observe(
            seconds, n_rows=n_rows, n_padded=bucket, n_queries=n_queries,
            n_recompiles=0, compile_s=0.0)
        fleet.pricer.observe(fleet.n_scenarios, bucket, seconds)
        return lat, rest, w_lat, raw

    # -- per-kind finalization ----------------------------------------------
    def _finalize(self, fleet: _Fleet, p: _Pending) -> QueryResult:
        q = p.query
        lat = np.concatenate(p.lat_cols, axis=1)     # (S, P) float32
        rest = np.concatenate(p.rest_cols, axis=1)
        raw = {n: np.concatenate(cols, axis=1)
               for n, cols in p.raw_cols.items()}
        if q.kind == "joint":
            feas = dq_caps_mask(p.placements, p.dq_values, q.coupling)
            scores, dq_idx = joint_dq_scores(
                lat, np.atleast_1d(p.dq_values), q.beta, rest=rest,
                w_lat=p.w_lat, feasible=feas)
            best, worst = robust_select(scores)
            return QueryResult(
                query_id=p.query_id, tenant=p.tenant, kind=q.kind,
                scores=scores, grids=raw or None, degraded=p.degraded,
                best=best, dq_idx=dq_idx, worst=worst,
                infeasible=bool(np.isinf(worst[best])))
        scores = finish_scores(lat, rest, p.w_lat, q.dq, q.beta)
        # per-objective finished grids: only latency_f carries the dq term
        grids = og = None
        if raw:
            denom = dq_denominator(q.dq, q.beta, lat.shape[0])
            grids = {n: (g / denom if n == "latency_f" else g)
                     for n, g in raw.items()}
            og = ObjectiveGrids(names=fleet.objectives.names, grids=grids,
                                scalarized=scores,
                                weights=fleet.objectives.weights)
        if q.kind == "score":
            return QueryResult(query_id=p.query_id, tenant=p.tenant,
                               kind=q.kind, scores=scores, grids=grids,
                               degraded=p.degraded)
        if q.kind == "pareto":
            front = pareto_front(og, scenario=q.scenario)
            return QueryResult(query_id=p.query_id, tenant=p.tenant,
                               kind=q.kind, scores=scores, grids=grids,
                               degraded=p.degraded, front=front)
        # rank
        if q.eps_caps or q.minimize is not None:
            best, masked = epsilon_constraint(
                og, q.minimize, q.eps_caps, scenario=q.scenario)
            order = np.argsort(masked, kind="stable")[:q.top_k]
            return QueryResult(
                query_id=p.query_id, tenant=p.tenant, kind=q.kind,
                scores=scores, grids=grids, degraded=p.degraded,
                top=order, worst=masked, best=int(best),
                infeasible=bool(np.isinf(masked[best])))
        best, worst = robust_select(scores)
        order = np.argsort(worst, kind="stable")[:q.top_k]
        return QueryResult(query_id=p.query_id, tenant=p.tenant,
                           kind=q.kind, scores=scores, grids=grids,
                           degraded=p.degraded, top=order, worst=worst,
                           best=int(best))
