"""Decision helpers: turn scored grids into choices — a copy of
``repro.search.decision`` (the port imports nothing of ``repro``).

Inputs are the (S, P) per-objective grids of one
``BatchedEvaluator.score_grid(objectives=...)`` call, as host arrays (an
:class:`~repro_torch.core.objectives.ObjectiveGrids` after ``to_host()``),
or plain (P, K) value matrices; outputs are selections:

  * :func:`robust_select`      — min–max: worst scenario per candidate,
    argmin over candidates;
  * :func:`split_dq_term`      — a raw (dq = 0, β = 0) result as
    ``rest + w_lat·lat/(1 + β·dq)``;
  * :func:`dq_caps_mask`       — vectorized DQCoupling feasibility;
  * :func:`joint_dq_scores`    — per-(scenario, candidate) dq
    co-optimization;
  * :func:`pareto_front`       — the non-dominated set over ≥2 objectives;
  * :func:`epsilon_constraint` — minimize one objective subject to caps on
    the others;
  * :class:`ObjectiveScales`   — per-objective (offset, scale) fitted from
    a sampled grid, so weights become dimensionless.

Everything here is plain numpy on already-computed host grids.  All
objectives are minimized.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ParetoFront",
    "ObjectiveScales",
    "candidate_values",
    "epsilon_constraint",
    "pareto_mask",
    "pareto_front",
    "scalarize",
    "robust_select",
    "split_dq_term",
    "dq_caps_mask",
    "joint_dq_scores",
]


# -- grid → per-candidate objective vectors -----------------------------------

def candidate_values(grids, scenario="worst") -> np.ndarray:
    """(P, K) objective vectors from an :class:`ObjectiveGrids`.

    ``scenario`` picks the row: an int takes that scenario's (P, K) slice;
    ``"worst"`` takes the per-objective max over scenarios — the
    conservative envelope the min–max decision rule already optimizes, so
    fronts extracted from it are robust trade-off menus."""
    cols = []
    for name in grids.names:
        g = np.asarray(grids.grids[name], dtype=np.float64)  # (S, P)
        cols.append(g.max(axis=0) if scenario == "worst"
                    else g[int(scenario)])
    return np.stack(cols, axis=1)


# -- Pareto extraction --------------------------------------------------------

def pareto_mask(values: np.ndarray) -> np.ndarray:
    """(P,) boolean — True where no other point dominates (minimization:
    ``y`` dominates ``x`` iff ``y ≤ x`` everywhere and ``y < x`` somewhere).
    Duplicates of a front point are all kept (they tie, neither dominates).
    O(P²) worst case, but each eliminated point is skipped as a pivot."""
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 2:
        raise ValueError(f"values must be (P, K), got {v.shape}")
    n = v.shape[0]
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominated = (v >= v[i]).all(axis=1) & (v > v[i]).any(axis=1)
        mask &= ~dominated
    return mask


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """Non-dominated candidates: ``indices`` into the scored placement
    batch, their ``values`` (M, K), and the objective ``names`` labelling
    the columns.  Rows are sorted by the first objective."""

    indices: np.ndarray
    values: np.ndarray
    names: tuple[str, ...]

    def __len__(self) -> int:
        return int(self.indices.size)

    def __iter__(self):
        for i in range(len(self)):
            yield int(self.indices[i]), self.values[i]


def pareto_front(grids_or_values, scenario="worst",
                 names: tuple[str, ...] | None = None) -> ParetoFront:
    """Extract the non-dominated set from an ObjectiveGrids (one score_grid
    dispatch holds the entire front) or a plain (P, K) value matrix."""
    if hasattr(grids_or_values, "grids"):
        values = candidate_values(grids_or_values, scenario)
        names = tuple(grids_or_values.names)
    else:
        values = np.asarray(grids_or_values, dtype=np.float64)
        names = tuple(names) if names is not None else \
            tuple(f"objective_{k}" for k in range(values.shape[1]))
    idx = np.flatnonzero(pareto_mask(values))
    order = np.argsort(values[idx, 0], kind="stable")
    idx = idx[order]
    return ParetoFront(indices=idx, values=values[idx], names=names)


# -- automatic objective normalization ----------------------------------------

@dataclasses.dataclass(frozen=True)
class ObjectiveScales:
    """Per-objective affine normalization ``(v − offset) / scale`` fit from
    a sampled grid (offset = min, scale = range).

    Because min and range are equivariant under ``v ↦ c·v`` (c > 0), the
    normalized values — and therefore any weighted selection over them —
    are invariant to rescaling an objective's units; weights act as
    dimensionless trade-off knobs on [0, 1]-ish normalized axes."""

    names: tuple[str, ...]
    offset: np.ndarray  # (K,)
    scale: np.ndarray   # (K,) strictly positive

    @classmethod
    def fit(cls, grids_or_values,
            names: tuple[str, ...] | None = None) -> "ObjectiveScales":
        """Fit from an ObjectiveGrids — pooling every (scenario, candidate)
        cell; to fit from one scenario's slice or the worst-case envelope,
        pass ``candidate_values(grids, scenario)`` instead — or from a
        plain (P, K) value matrix.

        Degenerate grids are well-defined, never a zero divide: an
        objective constant over the sample (max == min) gets scale 1 with
        offset = that constant, so every normalized value is exactly 0 and
        the objective contributes nothing to a normalized scalarization
        (which keeps the scale-invariance property).  Non-finite cells
        (±inf from feasibility masks, NaN) are ignored by the fit — and an
        objective with NO finite cell at all normalizes through (offset 0,
        scale 1), passing its ±inf through unchanged.  An empty sample
        (zero rows) raises — there is nothing to fit."""
        if hasattr(grids_or_values, "grids"):
            names = tuple(grids_or_values.names)
            values = np.stack(
                [np.asarray(grids_or_values.grids[n],
                            dtype=np.float64).ravel()
                 for n in names], axis=1)
        else:
            values = np.asarray(grids_or_values, dtype=np.float64)
            if values.ndim != 2:
                raise ValueError(f"values must be 2-D, got {values.shape}")
            names = tuple(names) if names is not None else \
                tuple(f"objective_{k}" for k in range(values.shape[1]))
        if values.shape[0] == 0:
            raise ValueError("cannot fit ObjectiveScales from an empty "
                             "sample (zero rows)")
        # explicit masked min/max — no all-NaN-slice RuntimeWarnings, no
        # nan/0 ranges to divide by later
        finite = np.isfinite(values)
        any_finite = finite.any(axis=0)
        lo = np.where(any_finite,
                      np.min(np.where(finite, values, np.inf), axis=0), 0.0)
        hi = np.where(any_finite,
                      np.max(np.where(finite, values, -np.inf), axis=0), 0.0)
        span = hi - lo
        return cls(names=names, offset=lo,
                   scale=np.where(span > 0.0, span, 1.0))

    def apply(self, values: np.ndarray) -> np.ndarray:
        """Normalize (…, K) objective values (∞ passes through as ∞)."""
        return (np.asarray(values, dtype=np.float64) - self.offset) \
            / self.scale


def scalarize(values: np.ndarray, weights,
              scales: ObjectiveScales | None = None) -> np.ndarray:
    """(P,) weighted sum over (P, K) objective values, optionally on the
    normalized axes (``scales``) so the weights are dimensionless."""
    v = np.asarray(values, dtype=np.float64)
    if scales is not None:
        v = scales.apply(v)
    return v @ np.asarray(weights, dtype=np.float64)


# -- ε-constraint selection ---------------------------------------------------

def epsilon_constraint(grids_or_values, minimize: str | int,
                       caps: dict[str, float] | None = None,
                       scenario="worst",
                       names: tuple[str, ...] | None = None,
                       atol: float = 0.0) -> tuple[int, np.ndarray]:
    """Minimize ONE objective subject to caps (ε) on the others — the
    classic ε-constraint scalarization, next to the weighted sum.

    Where a weighted scalarization asks "what is one unit of WAN traffic
    worth in latency?", the ε-constraint asks the question operators
    actually pose: "minimize latency, but never move more than ε bytes".
    It reuses the per-objective (S, P) grids ONE ``score_grid`` dispatch
    already produced (an :class:`~repro_torch.core.objectives.ObjectiveGrids`,
    or a plain (P, K) value matrix with ``names``) — no extra dispatches,
    same as :func:`pareto_front`.

    ``minimize`` is an objective name (or column index); ``caps`` maps
    other objective names to their ε bounds — objectives absent from
    ``caps`` are unconstrained (ε = ∞), so ``caps=None`` reduces exactly
    to the single-objective argmin over the ``minimize`` column (property
    tested).  ``scenario`` picks the row like :func:`candidate_values`
    ("worst" = the conservative envelope, an int = that scenario).

    Returns ``(index, masked (P,) scores)`` where infeasible candidates
    hold +inf and ``index`` is the first-occurrence argmin.  When NO
    candidate satisfies every cap, every score is +inf and ``index`` is 0
    — callers distinguish "infeasible" via ``np.isinf(scores[index])``
    (the serving layer turns that into a typed response)."""
    if hasattr(grids_or_values, "grids"):
        values = candidate_values(grids_or_values, scenario)
        names = tuple(grids_or_values.names)
    else:
        values = np.asarray(grids_or_values, dtype=np.float64)
        if values.ndim != 2:
            raise ValueError(f"values must be (P, K), got {values.shape}")
        names = tuple(names) if names is not None else \
            tuple(f"objective_{k}" for k in range(values.shape[1]))
    if isinstance(minimize, str):
        if minimize not in names:
            raise ValueError(f"minimize={minimize!r} not among {names}")
        k_min = names.index(minimize)
    else:
        k_min = int(minimize)
        if not 0 <= k_min < len(names):
            raise ValueError(f"minimize index {k_min} out of range "
                             f"for {len(names)} objectives")
    caps = dict(caps or {})
    unknown = set(caps) - set(names)
    if unknown:
        raise ValueError(f"caps name unknown objectives {sorted(unknown)}; "
                         f"choose from {names}")
    if names[k_min] in caps:
        raise ValueError(f"cannot cap the minimized objective "
                         f"{names[k_min]!r} — drop it from caps")
    cap_vec = np.array([caps.get(n, np.inf) for n in names],
                      dtype=np.float64)
    # a cap of +inf is satisfied by any finite value AND by +inf cells
    # (an unconstrained objective can never infeasible-ize a candidate)
    with np.errstate(invalid="ignore"):
        ok = (values <= cap_vec[None, :] + atol) | np.isinf(cap_vec)[None, :]
    feasible = ok.all(axis=1)
    scores = np.where(feasible, values[:, k_min], np.inf)
    return int(np.argmin(scores)), scores


# -- min–max robust selection and the dq co-optimization ----------------------

def robust_select(grid: np.ndarray) -> tuple[int, np.ndarray]:
    """Min–max over an (S, P) score grid: returns (argmin candidate index,
    (P,) worst-case scores).  First occurrence wins ties."""
    g = np.asarray(grid, dtype=np.float64)
    worst = g.max(axis=0)
    return int(np.argmin(worst)), worst


def split_dq_term(raw_result):
    """Split a RAW ``score_grid`` result (dispatched at dq = 0, β = 0) into
    ``(lat, rest, w_lat)`` with ``score = rest + w_lat·lat/(1 + β·dq)``.

    Only latency-F depends on dq (paper eq. 8).  ``raw_result`` is the plain
    latency grid (rest = 0, w_lat = 1) or an object with ``grids`` /
    ``scalarized`` / ``names`` / ``weights`` (an ``ObjectiveGrids`` on the
    host)."""
    if not hasattr(raw_result, "grids"):
        lat = np.asarray(raw_result, dtype=np.float64)
        return lat, np.zeros_like(lat), 1.0
    scal = np.asarray(raw_result.scalarized, dtype=np.float64)
    w_lat = dict(zip(raw_result.names,
                     raw_result.weights)).get("latency_f", 0.0)
    if "latency_f" in raw_result.names:
        lat = np.asarray(raw_result.grids["latency_f"], dtype=np.float64)
    else:
        lat = np.zeros_like(scal)
    return lat, scal - w_lat * lat, w_lat


def dq_caps_mask(placements, dq_values, coupling,
                 atol: float = 1e-7) -> np.ndarray | None:
    """(P, D) DQCoupling feasibility: per-device column mass ≤
    cap0 − dq·load.  None coupling ⇒ None (everything feasible)."""
    if coupling is None:
        return None
    col = np.asarray(placements, dtype=np.float64).sum(axis=1)   # (P, V)
    dq_values = np.atleast_1d(np.asarray(dq_values, dtype=np.float64))
    caps = (np.asarray(coupling.cap0, dtype=np.float64)[None, :]
            - dq_values[:, None]
            * np.asarray(coupling.load, dtype=np.float64)[None, :])
    return (col[:, None, :] <= caps[None, :, :] + atol).all(axis=-1)


def joint_dq_scores(lat: np.ndarray, dq_values: np.ndarray, beta: float,
                    rest: np.ndarray | None = None, w_lat: float = 1.0,
                    feasible: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Co-optimize ``dq_fraction`` per (scenario, candidate) cell.

    ``lat`` is the raw (S, P) latency grid; the (S, P, D) score tensor
    ``rest + w_lat·lat/(1 + β·dq_d)`` is expanded analytically, ``feasible``
    ((P, D)) masks infeasible pairs with +inf, and each cell keeps its best
    dq.  Returns ``(scores (S, P), dq_idx (S, P))``."""
    lat = np.asarray(lat, dtype=np.float64)
    dq_values = np.asarray(dq_values, dtype=np.float64)
    denom = 1.0 + float(beta) * dq_values                    # (D,)
    cube = w_lat * lat[:, :, None] / denom[None, None, :]    # (S, P, D)
    if rest is not None:
        cube = cube + np.asarray(rest, dtype=np.float64)[:, :, None]
    if feasible is not None:
        cube = np.where(np.asarray(feasible, dtype=bool)[None, :, :],
                        cube, np.inf)
    dq_idx = np.argmin(cube, axis=2)
    return np.take_along_axis(cube, dq_idx[:, :, None], axis=2)[:, :, 0], \
        dq_idx
