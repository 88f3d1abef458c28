"""Single-host what-if serving on PyTorch: coalesced, cost-priced, one raw
``score_grid`` and one host transfer per padded chunk."""

from repro_torch.serve.admission import (AdmissionConfig, Admitted, Degraded,
                                         DispatchPricer, Rejected, decide)
from repro_torch.serve.bucketing import (CoalesceKey, finish_scores,
                                         fleet_digest, next_pow2, pad_rows)
from repro_torch.serve.cache import BucketStats, ServeStats
from repro_torch.serve.service import (QueryResult, QueryTicket, ResultChunk,
                                       WhatIfQuery, WhatIfService)

__all__ = [
    "WhatIfService", "WhatIfQuery", "QueryTicket", "ResultChunk",
    "QueryResult", "AdmissionConfig", "Admitted", "Degraded", "Rejected",
    "DispatchPricer", "decide", "CoalesceKey", "fleet_digest",
    "finish_scores", "next_pow2", "pad_rows", "BucketStats", "ServeStats",
]
