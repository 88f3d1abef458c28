"""PyTorch twin of the paper's cost model — the counterpart of
``repro.core.jaxmodel``, in two halves.

The smoothed model (:class:`SmoothConfig`, :func:`make_latency_fn`,
:func:`make_objective_fn`) scores ONE placement with every max optionally
replaced by ``temp·logsumexp(·/temp)`` and the enabledLinks indicator by
``x/(x + link_eps)``, so the objective is C¹ and torch autograd gives the
gradient ``projected_gradient`` descends.  It is plain tensor code: the
reference computes it without a Pallas kernel too.

The hard-max what-if scorers behind ``BatchedEvaluator`` (``temp = 0``).
Unlike the JAX twins, which score one placement and are ``vmap``-ed by the
evaluator, each of them takes a leading batch axis: ``x`` is (B, n_ops, V), a dense ``com`` is (Bc, V, V) and a
structured scenario is ``inter`` (Sb, R, R) + ``degrade`` (Sb, V), with
Bc, Sb ∈ {1, B} (1 = one scenario shared by the whole batch, never
replicated).

Per edge ``i → j`` the math is the reference's:

  dense       t_u = Σ_v com_{u,v} · x_{j,v}
  structured  t_u = d_u · Σ_r inter[r_u, r] · mass_r
                    + (self_cost − d_u²·inter[r_u, r_u]) · x_{j,u}
              mass_r = Σ_{v ∈ region r} d_v · x_{j,v}
  edgeLat     max_u x_{i,u}·s_i·t_u  (+ α·enabledLinks)

and the bilinear max runs through :mod:`repro_torch.kernels.dispatch`
(the CUDA kernels on the card, the plain versions on the CPU).  The region
mass is a product with a fixed (V, R) degrade-weighted one-hot matrix,
not a scatter: ``index_add_`` on CUDA accumulates with atomics in an order
that changes from run to run, the product does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.devices import ExplicitFleet, RegionFleet
from repro_torch.core.graph import OpGraph
from repro_torch.kernels import dispatch

__all__ = ["SmoothConfig", "make_latency_fn", "make_objective_fn",
           "edge_endpoints", "links_term", "critical_path_dp",
           "make_edge_latencies_com_fn", "region_factors", "region_onehot",
           "region_mass", "structured_edge_latency",
           "make_edge_latencies_region_fn", "require_fp32_matmul"]


def _edge_arrays(graph: OpGraph):
    src = np.array([i for i, _ in graph.edges], dtype=np.int64)
    dst = np.array([j for _, j in graph.edges], dtype=np.int64)
    sel = np.array([graph.operators[i].selectivity for i, _ in graph.edges])
    return src, dst, sel


def _edge_tensors(graph: OpGraph, device):
    """(src, dst) int64 and float32 selectivity tensors on ``device``."""
    src, dst, sel = _edge_arrays(graph)
    return (torch.as_tensor(src, device=device),
            torch.as_tensor(dst, device=device),
            torch.as_tensor(sel, dtype=torch.float32, device=device))


def edge_endpoints(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   sel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, E, V) endpoint rows: x_i with the source selectivity folded in,
    and x_j.  Scenario-independent, so a grid computes them once."""
    return x[:, src] * sel[None, :, None], x[:, dst]


def links_term(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               alpha: float, nz_eps: float) -> torch.Tensor:
    """α·enabledLinks per edge, (B, E), with the hard indicator
    ``x > nz_eps`` (paper-exact)."""
    nz = (x > nz_eps).to(x.dtype)
    counts = nz.sum(dim=-1)                                  # (B, n_ops)
    both = (nz[:, src] * nz[:, dst]).sum(dim=-1)             # (B, E)
    return alpha * (counts[:, src] * counts[:, dst] - both)


def critical_path_dp(graph: OpGraph, elat: torch.Tensor) -> torch.Tensor:
    """(..., E) edge latencies → (...,) critical-path latency, unrolled over
    the static topo order with whatever leading shape ``elat`` carries."""
    zero = elat.new_zeros(elat.shape[:-1])
    dist: dict[int, torch.Tensor] = {}
    for i in graph.topo_order:
        incoming = [dist[ip] + elat[..., e] for ip, e in graph.in_edges(i)]
        dist[i] = torch.stack(incoming).amax(dim=0) if incoming else zero
    sinks = graph.sinks
    return torch.stack([dist[s] for s in sinks]).amax(dim=0) \
        if sinks else zero


def make_edge_latencies_com_fn(graph: OpGraph, alpha: float = 0.0,
                               nz_eps: float = 0.0, device=None):
    """Returns ``elat(x (B, n, V), com (Bc, V, V)) -> (B, E)``: both the
    placement batch and the com matrices are arguments, so one function
    scores any dense scenario pack.  ``device=None`` means the card and
    raises without CUDA; pass ``device="cpu"`` for the plain versions."""
    src, dst, sel = _edge_tensors(graph, dispatch.resolve_device(device))

    def elat(x: torch.Tensor, com: torch.Tensor) -> torch.Tensor:
        x_i, x_j = edge_endpoints(x, src, dst, sel)
        out = dispatch.edge_latency(x_i, x_j, com)
        if alpha:
            out = out + links_term(x, src, dst, alpha, nz_eps)
        return out

    return elat


def region_factors(inter: torch.Tensor, degrade: torch.Tensor,
                   region_ix: torch.Tensor, self_cost: float):
    """The structured pricing rule, factored once for every consumer:

        a[s, r, u]  = degrade[s, u] · inter[s, region_u, r]       (Sb, R, V)
        corr[s, u]  = self_cost − degrade[s, u]² · inter[s, r_u, r_u]   (Sb, V)

    so ``t = mass @ a + corr·x_j`` prices one scenario's per-device
    transfer times (the reference's ``_region_factors``, batched)."""
    a = degrade[:, None, :] * inter.transpose(-1, -2)[..., region_ix]
    diag = torch.diagonal(inter, dim1=-2, dim2=-1)[..., region_ix]
    corr = self_cost - degrade * degrade * diag
    return a, corr


def region_onehot(region_ix: torch.Tensor, n_regions: int) -> torch.Tensor:
    """(V, R) float32 one-hot of the static region layout."""
    return torch.nn.functional.one_hot(region_ix, n_regions).to(torch.float32)


def require_fp32_matmul(t: torch.Tensor, what: str) -> None:
    """Raise before a float32 matrix product on the card would run in TF32.

    TF32 keeps about three decimal digits, far outside the 1e-5 bar, and
    ``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.set_float32_matmul_precision("high")`` switch every cuBLAS
    float32 product of the process to it.  The port raises rather than
    pinning the precision around the product: a process-wide switch is the
    caller's, and flipping it here would change other threads' products.
    CPU tensors never run in TF32, so they pass."""
    if t.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{what} need full-FP32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def region_mass(x_j: torch.Tensor, degrade: torch.Tensor,
                onehot: torch.Tensor) -> torch.Tensor:
    """(B, E, R) ``mass[b, e, r] = Σ_{v ∈ region r} degrade_v · x_j[b, e, v]``
    as ``x_j @ (onehot · degrade)``: each term is the same single-rounded
    product the reference's scatter adds, and the summation order is fixed,
    so two calls give bitwise-equal masses.  ``degrade`` is (Sb, V).  The
    product is cuBLAS on the card, so it raises when TF32 matmuls are on
    (:func:`require_fp32_matmul`)."""
    require_fp32_matmul(x_j, "the structured region masses")
    w = onehot[None] * degrade[:, :, None]                   # (Sb, V, R)
    if w.shape[0] == 1:
        return torch.matmul(x_j, w[0])
    return torch.bmm(x_j, w)


def structured_edge_latency(x_i, x_j, inter, degrade, region_ix, onehot,
                            self_cost: float) -> torch.Tensor:
    """(B, E) structured edge-latency max from precomputed endpoint rows,
    for ``inter`` (Sb, R, R) and ``degrade`` (Sb, V) with Sb ∈ {1, B}."""
    mass = region_mass(x_j, degrade, onehot)
    a, corr = region_factors(inter, degrade, region_ix, self_cost)
    return dispatch.edge_latency_structured(x_i, x_j, mass, a,
                                            corr[:, None, :])


def make_edge_latencies_region_fn(graph: OpGraph, region: np.ndarray,
                                  n_regions: int, self_cost: float = 0.0,
                                  alpha: float = 0.0, nz_eps: float = 0.0,
                                  device=None):
    """Returns ``elat(x (B, n, V), inter (Sb, R, R), degrade (Sb, V)) ->
    (B, E)`` — the structured twin of :func:`make_edge_latencies_com_fn`.
    ``region``/``n_regions``/``self_cost`` are static family structure; no
    (V, V) array exists anywhere.  ``device`` as for
    :func:`make_edge_latencies_com_fn`."""
    device = dispatch.resolve_device(device)
    src, dst, sel = _edge_tensors(graph, device)
    region_ix = torch.as_tensor(np.asarray(region, dtype=np.int64),
                                device=device)
    onehot = region_onehot(region_ix, n_regions)

    def elat(x: torch.Tensor, inter: torch.Tensor,
             degrade: torch.Tensor) -> torch.Tensor:
        x_i, x_j = edge_endpoints(x, src, dst, sel)
        out = structured_edge_latency(x_i, x_j, inter, degrade, region_ix,
                                      onehot, self_cost)
        if alpha:
            out = out + links_term(x, src, dst, alpha, nz_eps)
        return out

    return elat


# -- the smoothed single-placement model (the gradient path) -----------------

@dataclasses.dataclass(frozen=True)
class SmoothConfig:
    """temp=0 ⇒ hard max (paper-exact); temp>0 ⇒ logsumexp smoothing.
    link_eps smooths the enabledLinks indicator: nz(x) ≈ x/(x+eps)."""

    alpha: float = 0.0
    temp: float = 0.0
    link_eps: float = 1e-4


def _smax(v: torch.Tensor, temp: float, dim: int) -> torch.Tensor:
    """Hard max at temp 0, else ``temp·logsumexp(v/temp)``.  The logsumexp
    is written out as JAX's (a max with no gradient, exp, sum, log), so
    autograd forms the reference's gradient ``exp(a − max)/Σ`` with its
    roundings: ``torch.logsumexp``'s backward, ``exp(a − lse)``, loses
    |lse|·ε in the exponent, 5e-6 relative at temp 0.005."""
    if temp <= 0.0:
        return v.amax(dim=dim)
    a = v / temp
    amax = a.amax(dim=dim, keepdim=True).detach()
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = torch.exp(a - amax).sum(dim=dim)
    return temp * (torch.log(s) + amax.squeeze(dim))


def _soft_nz(x: torch.Tensor, eps: float, hard: bool) -> torch.Tensor:
    if hard:
        return (x > 0).to(x.dtype)
    return x / (x + eps)


def _edge_latency(x_i, x_j, s_i, t, cfg: SmoothConfig) -> torch.Tensor:
    """(E,) edge latencies from the (E, V) endpoint rows, the (E, 1)
    source selectivities and the (E, V) transfer times ``t = com·x_j``:
    the reference's per-edge ``_edge_latency``, for every edge at once."""
    base = _smax(x_i * s_i * t, cfg.temp, dim=-1)
    if cfg.alpha:
        hard = cfg.temp <= 0.0
        nz_i = _soft_nz(x_i, cfg.link_eps, hard)
        nz_j = _soft_nz(x_j, cfg.link_eps, hard)
        links = nz_i.sum(dim=-1) * nz_j.sum(dim=-1) \
            - (nz_i * nz_j).sum(dim=-1)
        base = base + cfg.alpha * links
    return base


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def make_latency_fn(graph: OpGraph, fleet: ExplicitFleet | RegionFleet,
                    cfg: SmoothConfig = SmoothConfig(), device=None):
    """Returns ``lat(x) -> scalar`` for one float32 (n_ops, V) placement on
    ``device`` (``None`` → the card; ``"cpu"`` for the CPU).

    The transfer times of every edge come from one product: ``x_j @ comᵀ``
    for an :class:`ExplicitFleet`; for a :class:`RegionFleet` the region
    masses (``region_mass``, the degrade-weighted one-hot product) times the
    (V, R) degrade-scaled inter costs, plus the self-cost correction, as the
    reference's ``com_times``.  Both are float32 cuBLAS products on the
    card, so they raise when TF32 matmuls are on
    (:func:`require_fp32_matmul`).  The critical-path DP unrolls over the
    static topo order; with temp>0 the max over parents and sinks is also
    smoothed, so the whole objective is C¹ and autograd differentiates it.
    """
    dev = dispatch.resolve_device(device)
    src, dst, sel = _edge_tensors(graph, dev)
    sel = sel[:, None]
    if isinstance(fleet, RegionFleet):
        d = fleet.degrade_or_ones()
        inter_dev_t = _f32((fleet.inter[fleet.region] * d[:, None]).T, dev)
        corr = _f32(fleet.self_cost - d * d
                    * np.diag(fleet.inter)[fleet.region], dev)
        d_row = _f32(d, dev)[None]
        onehot = region_onehot(torch.as_tensor(
            np.asarray(fleet.region, dtype=np.int64), device=dev),
            fleet.n_regions)

        def com_times(x_j):
            require_fp32_matmul(x_j, "the smoothed model's transfer times")
            mass = region_mass(x_j, d_row, onehot)          # (E, R)
            return torch.matmul(mass, inter_dev_t) + corr * x_j
    else:
        com_t = _f32(fleet.com_cost, dev).T

        def com_times(x_j):
            require_fp32_matmul(x_j, "the smoothed model's transfer times")
            return torch.matmul(x_j, com_t)

    def lat(x: torch.Tensor) -> torch.Tensor:
        x_j = x[dst]
        elat = _edge_latency(x[src], x_j, sel, com_times(x_j), cfg)
        zero = x.new_zeros(())
        dist: dict[int, torch.Tensor] = {}
        for i in graph.topo_order:
            incoming = [dist[ip] + elat[e] for ip, e in graph.in_edges(i)]
            dist[i] = (_smax(torch.stack(incoming), cfg.temp, dim=0)
                       if incoming else zero)
        sinks = [dist[s] for s in graph.sinks]
        return _smax(torch.stack(sinks), cfg.temp, dim=0) if sinks else zero

    return lat


def make_objective_fn(graph: OpGraph, fleet: ExplicitFleet | RegionFleet,
                      beta: float, cfg: SmoothConfig = SmoothConfig(),
                      device=None):
    """``obj(x, dq_fraction) -> F`` (paper eq. 8), differentiable in both."""
    lat = make_latency_fn(graph, fleet, cfg, device)

    def obj(x: torch.Tensor, dq_fraction) -> torch.Tensor:
        return lat(x) / (1.0 + beta * dq_fraction)

    return obj
