"""Streaming operators: the executable counterpart of the paper's ``V_op`` —
the port of ``repro.streaming.operators``.

A :class:`StreamOperator` couples the cost-model metadata (selectivity,
work, DQ eligibility) with an actual batch function, so the same DAG object
is both *optimized* (``repro_torch.core``) and *executed*
(:mod:`repro_torch.streaming.engine`).  Model inference is just another
operator: :func:`model_op` scores token windows with a ``DecoderLM`` (dense
or MoE), a ``Mamba2LM`` or a ``Zamba2LM`` on its device, through the
flash-attention kernel when the model's config asks for
``attention_impl="pallas"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import Operator, OpGraph
from repro_torch.models.layers import token_cross_entropy
from repro_torch.streaming.quality import quality_scores

__all__ = ["StreamOperator", "StreamGraph", "source", "map_op", "filter_op",
           "window_agg", "quality_op", "model_op"]


@dataclasses.dataclass
class StreamOperator:
    name: str
    fn: Callable[[np.ndarray], np.ndarray]  # rows → rows
    selectivity: float = 1.0
    out_bytes: float = 8.0
    work: float = 1.0
    dq_eligible: bool = False

    def to_meta(self) -> Operator:
        return Operator(self.name, self.selectivity, self.out_bytes,
                        self.work, self.dq_eligible)


class StreamGraph:
    """Executable operator DAG + its cost-model shadow."""

    def __init__(self, operators: list[StreamOperator],
                 edges: list[tuple[int, int]]):
        self.ops = operators
        self.meta = OpGraph([o.to_meta() for o in operators], edges)

    @property
    def edges(self):
        return self.meta.edges


# -------------------------------------------------------- constructors -----

def source(name: str = "source") -> StreamOperator:
    return StreamOperator(name, fn=lambda x: x, selectivity=1.0, work=0.0)


def map_op(name: str, fn, out_bytes: float = 8.0,
           work: float = 1.0) -> StreamOperator:
    return StreamOperator(name, fn=fn, selectivity=1.0, out_bytes=out_bytes,
                          work=work)


def filter_op(name: str, predicate, selectivity: float,
              work: float = 0.5) -> StreamOperator:
    def fn(rows):
        keep = predicate(rows)
        return rows[keep]

    return StreamOperator(name, fn=fn, selectivity=selectivity, work=work)


def window_agg(name: str, window: int, agg=np.mean,
               work: float = 1.0) -> StreamOperator:
    def fn(rows):
        n = (len(rows) // window) * window
        if n == 0:
            return rows[:0]
        return agg(rows[:n].reshape(-1, window, *rows.shape[1:]), axis=1)

    return StreamOperator(name, fn=fn, selectivity=1.0 / window, work=work)


def quality_op(name: str = "dq_check", threshold: float = 0.5,
               work: float = 2.0) -> StreamOperator:
    """The paper's data-quality operator: scores rows, drops low quality."""
    def fn(rows):
        r = rows if rows.ndim == 2 else rows[:, None]
        scores = quality_scores(r.astype(np.int64), missing_sentinel=-1)
        return rows[scores >= threshold]

    return StreamOperator(name, fn=fn, selectivity=0.95, work=work,
                          dq_eligible=True)


def model_op(name: str, model, work: float = 50.0,
             out_bytes: float = 4.0) -> StreamOperator:
    """LM scoring as a streaming operator: rows are (S,) token windows;
    output is one score per row, float32 (n, 1) numpy.

    As the reference: tokens are cast to int32 and clipped to
    [0, vocab − 1], and a row's score is its mean next-token cross-entropy
    over the full padded logits; an MoE model's aux loss is dropped.  The
    model (a text model of ``build_model``'s, which holds its parameters;
    the reference passes ``params`` and ``cfg`` beside it) runs under
    ``torch.inference_mode()`` on its own device."""
    vocab = model.cfg.vocab

    def fn(rows):
        toks = np.clip(rows.astype(np.int32), 0, vocab - 1)
        with torch.inference_mode():
            t = torch.as_tensor(toks, device=model.device)
            logits, _ = model({"tokens": t})
            scores = token_cross_entropy(logits[:, :-1], t[:, 1:]).mean(-1)
            return scores.float().cpu().numpy()[:, None]

    return StreamOperator(name, fn=fn, selectivity=1.0, work=work,
                          out_bytes=out_bytes)
