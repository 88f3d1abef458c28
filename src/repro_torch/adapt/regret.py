"""Regret accounting for the closed adaptive loop: was adapting worth it?

The controller's benefit claim is a *number*: cumulative objective F over
the trace of three policies on the SAME true world —

  * **static**   — the seed placement held fixed (remapped mechanically on
    device losses, never re-optimized),
  * **adaptive** — the controller's placement, PLUS the reconfiguration
    cost charged every time it switches (state-movement bytes priced by
    the com model — adaptation is not free),
  * **oracle**   — a placement re-optimized against the true fleet and the
    true (drift-included) operator graph whenever the world changes; the
    hindsight reference both regrets are measured against.

``regret = cumulative F − cumulative oracle F``; the closed loop earns its
keep when ``adaptive_regret < static_regret`` on drifting traces.

numpy copy of ``repro.adapt.regret`` for the PyTorch port.  Every result is
bitwise equal to the reference's; :func:`_greedy_transport` reaches the
reference's sum without its per-pair Python loop, so a reconfiguration
charge at thousands of devices costs a fraction of a second.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import OpGraph

__all__ = ["RegretReport", "reconfiguration_cost"]


def _greedy_transport(outflow: np.ndarray, inflow: np.ndarray,
                      com: np.ndarray) -> float:
    """Cheapest-pair greedy transport cost: route outflow mass to inflow
    destinations over the cheapest links first (a migration planner avoids
    degraded links; pricing every pair proportionally would bill a move
    AWAY from an outage as if the state crossed the outage twice).
    Deterministic: pairs scanned in (cost, u, v) order.

    The reference scans every (source, destination) pair in that order and
    skips a pair once either end is exhausted.  Here the pairs come in
    rounds: the cheapest eighth of the pairs between the ends still live
    (``np.ix_`` lists them in (u, v) order, so a stable sort on the cost
    alone is the (cost, u, v) order), the next live pair found by a
    vectorized scan.  A pair cheaper than the round's cut has had both ends
    live when it was scanned, so no pair of two live ends is left below the
    cut, and the next round is the live block again.  The same pairs are
    charged in the same order, so the sum is bitwise the reference's."""
    out = outflow.copy()
    inn = inflow.copy()
    live_u, live_v = out > 1e-12, inn > 1e-12
    total = 0.0
    while True:
        src, dst = np.flatnonzero(live_u), np.flatnonzero(live_v)
        if not src.size or not dst.size:
            return total
        block = com[np.ix_(src, dst)].ravel()
        k = max(4 * (src.size + dst.size), block.size // 8)
        if block.size > k:
            flat = np.flatnonzero(block <= np.partition(block, k - 1)[k - 1])
        else:
            flat = np.arange(block.size)
        flat = flat[np.argsort(block[flat], kind="stable")]
        cu, cv, cost = src[flat // dst.size], dst[flat % dst.size], block[flat]
        i, win = 0, 16
        while i < cost.size:
            hit = np.flatnonzero(live_u[cu[i:i + win]] & live_v[cv[i:i + win]])
            if not hit.size:
                i += win
                win *= 2
                continue
            i += int(hit[0])
            u, v = int(cu[i]), int(cv[i])
            m = min(out[u], inn[v])
            total += m * cost[i]
            out[u] -= m
            inn[v] -= m
            live_u[u] = out[u] > 0.0
            live_v[v] = inn[v] > 0.0
            i += 1
            win = 16


def reconfiguration_cost(x_old: np.ndarray, x_new: np.ndarray,
                         graph: OpGraph, fleet,
                         state_bytes_per_op: float = 1.0) -> float:
    """Price of switching placements: the operator state that must move,
    in the com model's own units.

    Operator i's state is ``state_bytes_per_op · out_bytes_i`` bytes per
    unit of placement mass; switching moves ``outflow = max(x_old − x_new,
    0)`` into ``inflow = max(x_new − x_old, 0)`` along a cheapest-links
    greedy transport plan priced by ``comCost`` — the same units as
    modeled latency, so the charge is directly comparable to the per-tick
    F it buys back."""
    x_old = np.asarray(x_old, dtype=np.float64)
    x_new = np.asarray(x_new, dtype=np.float64)
    if x_old.shape != x_new.shape:
        raise ValueError(f"placement shapes differ: {x_old.shape} vs "
                         f"{x_new.shape}")
    com = np.asarray(fleet.com_matrix(), dtype=np.float64)
    total = 0.0
    for i, op in enumerate(graph.operators):
        diff = x_new[i] - x_old[i]
        inflow = np.maximum(diff, 0.0)
        if float(inflow.sum()) <= 1e-12:
            continue
        outflow = np.maximum(-diff, 0.0)
        price = _greedy_transport(outflow, inflow, com)
        total += state_bytes_per_op * op.out_bytes * price
    return float(total)


@dataclasses.dataclass
class RegretReport:
    """Per-tick and cumulative F of {static, adaptive, oracle} on the true
    world, plus the controller's decision record.

    ``f_adaptive`` is the raw per-tick objective; the reconfiguration
    charges live separately in ``reconfig_costs`` (non-zero only at switch
    ticks) and are INCLUDED in ``cum_adaptive`` — the adaptive policy pays
    for its own moves.  ``controller_dispatches`` counts the jitted search
    dispatches the controller issued; the O(reconfigs)-not-O(ticks) claim
    is gated on it in ``benchmarks/bench_adaptive.py``.
    """

    scenario: str
    f_static: np.ndarray
    f_adaptive: np.ndarray
    f_oracle: np.ndarray
    reconfig_costs: np.ndarray
    drift: np.ndarray            # controller drift signal per tick (NaN warmup)
    reconfig_ticks: list[int]
    refit_ticks: list[int]
    n_refits: int
    n_reconfigs: int
    controller_dispatches: int
    oracle_dispatches: int
    final_com_scale: float

    @property
    def n_ticks(self) -> int:
        return int(self.f_static.size)

    @property
    def cum_static(self) -> float:
        return float(self.f_static.sum())

    @property
    def cum_adaptive(self) -> float:
        """Adaptive cumulative F including its reconfiguration charges."""
        return float(self.f_adaptive.sum() + self.reconfig_costs.sum())

    @property
    def cum_oracle(self) -> float:
        return float(self.f_oracle.sum())

    @property
    def static_regret(self) -> float:
        return self.cum_static - self.cum_oracle

    @property
    def adaptive_regret(self) -> float:
        return self.cum_adaptive - self.cum_oracle

    def summary(self) -> dict:
        return {
            "scenario": self.scenario,
            "n_ticks": self.n_ticks,
            "cum_static": self.cum_static,
            "cum_adaptive": self.cum_adaptive,
            "cum_oracle": self.cum_oracle,
            "static_regret": self.static_regret,
            "adaptive_regret": self.adaptive_regret,
            "reconfig_cost_total": float(self.reconfig_costs.sum()),
            "n_refits": self.n_refits,
            "n_reconfigs": self.n_reconfigs,
            "controller_dispatches": self.controller_dispatches,
            "oracle_dispatches": self.oracle_dispatches,
            "final_com_scale": self.final_com_scale,
        }
