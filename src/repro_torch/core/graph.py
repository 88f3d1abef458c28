"""Operator DAGs for streaming analytics jobs (paper §3, Table 2).

An :class:`OpGraph` is the paper's ``G_op = (V_op, E_op)``: vertices are
operators (a set of pipelined job steps that run on one device class), edges
are data re-distributions (shuffles).  Each operator carries a selectivity
``s_i`` (output tuples per input tuple) and, as an extension used by
auto-sharding (DESIGN.md §2), an optional compute ``work`` and output tuple
size in bytes.

The paper defines total latency over *paths* from a source to the operator
just upstream of a sink; enumerating paths is exponential, so the cost model
evaluates the identical quantity with a topological-order DP (O(V+E)).  Path
enumeration is kept here for oracle tests on small graphs.

numpy-only copy of ``repro.core.graph`` for the PyTorch port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Operator", "OpGraph", "linear_graph", "diamond_graph", "random_dag"]


@dataclasses.dataclass(frozen=True)
class Operator:
    """One vertex of ``G_op``.

    Attributes:
      name: unique operator name.
      selectivity: ``s_i`` — output tuples per input tuple.  Sources have
        ``s=1`` per the paper; sinks' selectivity has no effect.
      out_bytes: average output tuple size (used by the byte-weighted
        network-movement objective of paper §3.1 and by calibration).
      work: abstract compute units per input batch (0 ⇒ paper-faithful
        "execution latency is negligible" assumption).
      dq_eligible: whether data-quality checks may run inside this operator.
    """

    name: str
    selectivity: float = 1.0
    out_bytes: float = 1.0
    work: float = 0.0
    dq_eligible: bool = False


class OpGraph:
    """A DAG of operators with edges representing data shuffling."""

    def __init__(self, operators: Sequence[Operator], edges: Iterable[tuple[int, int]]):
        self.operators = list(operators)
        self.edges = [(int(i), int(j)) for i, j in edges]
        n = len(self.operators)
        names = [op.name for op in self.operators]
        if len(set(names)) != n:
            raise ValueError(f"duplicate operator names: {names}")
        for i, j in self.edges:
            if not (0 <= i < n and 0 <= j < n):
                raise ValueError(f"edge ({i},{j}) out of range for {n} operators")
            if i == j:
                raise ValueError(f"self-loop on operator {i}")
        self._out = [[] for _ in range(n)]
        self._in = [[] for _ in range(n)]
        for e, (i, j) in enumerate(self.edges):
            self._out[i].append((j, e))
            self._in[j].append((i, e))
        self.topo_order = self._toposort()

    # -- structure ---------------------------------------------------------
    @property
    def n_ops(self) -> int:
        return len(self.operators)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def successors(self, i: int) -> list[int]:
        return [j for j, _ in self._out[i]]

    def predecessors(self, j: int) -> list[int]:
        return [i for i, _ in self._in[j]]

    def out_edges(self, i: int) -> list[tuple[int, int]]:
        """[(dst, edge_index)] for operator ``i``."""
        return list(self._out[i])

    def in_edges(self, j: int) -> list[tuple[int, int]]:
        return list(self._in[j])

    @property
    def sources(self) -> list[int]:
        return [i for i in range(self.n_ops) if not self._in[i]]

    @property
    def sinks(self) -> list[int]:
        return [i for i in range(self.n_ops) if not self._out[i]]

    def selectivities(self) -> np.ndarray:
        return np.array([op.selectivity for op in self.operators], dtype=np.float64)

    def _toposort(self) -> list[int]:
        n = self.n_ops
        indeg = [len(self._in[i]) for i in range(n)]
        stack = [i for i in range(n) if indeg[i] == 0]
        order: list[int] = []
        while stack:
            i = stack.pop()
            order.append(i)
            for j, _ in self._out[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    stack.append(j)
        if len(order) != n:
            raise ValueError("graph has a cycle — G_op must be a DAG")
        return order

    # -- paths (oracle; exponential — small graphs only) --------------------
    def edge_paths(self) -> list[list[int]]:
        """All source→sink paths, each as a list of *edge indices*.

        Per the paper, a path runs from a source to the operator just
        upstream of a sink; the edge into the sink is the last contributor.
        A source that is also a sink contributes an empty path (no edges).
        """
        paths: list[list[int]] = []

        def walk(i: int, acc: list[int]):
            if not self._out[i]:
                paths.append(list(acc))
                return
            for j, e in self._out[i]:
                acc.append(e)
                walk(j, acc)
                acc.pop()

        for s in self.sources:
            walk(s, [])
        return paths

    # -- cumulative selectivity (input rate scaling per operator) ----------
    def cumulative_rates(self) -> np.ndarray:
        """Relative input rate of each operator w.r.t. unit source rate.

        rate(source)=1; rate(j) = Σ_{i∈pred(j)} rate(i)·s_i.  Used by the
        byte-weighted objectives and by the streaming engine for batch sizing.
        """
        rate = np.zeros(self.n_ops, dtype=np.float64)
        for i in self.topo_order:
            if not self._in[i]:
                rate[i] = 1.0
        for i in self.topo_order:
            for j, _ in self._out[i]:
                rate[j] += rate[i] * self.operators[i].selectivity
        return rate

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OpGraph(n_ops={self.n_ops}, n_edges={self.n_edges})"


# -- constructors ------------------------------------------------------------

def linear_graph(selectivities: Sequence[float], **op_kwargs) -> OpGraph:
    """Chain 0→1→…→n-1 (the paper's worked-example topology)."""
    ops = [
        Operator(name=f"op{i}", selectivity=float(s), **op_kwargs)
        for i, s in enumerate(selectivities)
    ]
    edges = [(i, i + 1) for i in range(len(ops) - 1)]
    return OpGraph(ops, edges)


def diamond_graph(s_src=1.0, s_left=0.5, s_right=2.0) -> OpGraph:
    """src → {left, right} → sink; exercises multi-path critical-path logic."""
    ops = [
        Operator("src", s_src),
        Operator("left", s_left),
        Operator("right", s_right),
        Operator("sink", 1.0),
    ]
    return OpGraph(ops, [(0, 1), (0, 2), (1, 3), (2, 3)])


def random_dag(n_ops: int, edge_prob: float, rng: np.random.Generator,
               max_selectivity: float = 2.0) -> OpGraph:
    """Random layered DAG (edges only i<j) for property tests and benches."""
    ops = [
        Operator(f"op{i}", float(rng.uniform(0.1, max_selectivity)))
        for i in range(n_ops)
    ]
    edges = []
    for j in range(1, n_ops):
        parents = [i for i in range(j) if rng.random() < edge_prob]
        if not parents:  # keep connected
            parents = [int(rng.integers(0, j))]
        edges.extend((i, j) for i in parents)
    return OpGraph(ops, edges)
