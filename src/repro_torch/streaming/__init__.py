"""Streaming execution of the paper's operator DAGs on the port: operators
(LM scoring among them), data-quality scoring and the engine."""

from repro_torch.streaming.engine import BatchReport, StreamingEngine
from repro_torch.streaming.operators import (StreamGraph, StreamOperator,
                                             filter_op, map_op, model_op,
                                             quality_op, source, window_agg)
from repro_torch.streaming.quality import (dq_latency_model, quality_scores,
                                           quality_scores_torch)

__all__ = ["BatchReport", "StreamingEngine", "StreamGraph", "StreamOperator",
           "filter_op", "map_op", "model_op", "quality_op", "source",
           "window_agg", "dq_latency_model", "quality_scores",
           "quality_scores_torch"]
