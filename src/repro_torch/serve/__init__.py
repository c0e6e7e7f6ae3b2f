"""Always-on enumeration serving layer (DESIGN.md §7), over the port's
session on the CUDA card.

Admission → coalescing → execution over `repro_torch.core.session`:

  service    — EnumerationService: the long-lived server + dispatcher
  admission  — bounded FIFO, per-tenant quotas, backpressure
  coalescer  — continuous same-bucket batching (lane budget / time window)
  stream     — per-client ResultStream handles (chunks + terminal status)
  metrics    — counters, latency percentiles, QPS, occupancy, upload-cache stats

Entry point: ``python -m repro_torch.launch.serve --smoke`` (add
``--device cpu`` without a card).
"""

from repro_torch.serve.admission import Backpressure, QuotaExceeded
from repro_torch.serve.coalescer import Coalescer
from repro_torch.serve.metrics import ServiceMetrics, format_snapshot
from repro_torch.serve.service import EnumerationService, ServiceConfig
from repro_torch.serve.stream import ResultChunk, ResultStatus, ResultStream, ServiceError

__all__ = [
    "Backpressure",
    "Coalescer",
    "EnumerationService",
    "QuotaExceeded",
    "ResultChunk",
    "ResultStatus",
    "ResultStream",
    "ServiceConfig",
    "ServiceError",
    "ServiceMetrics",
    "format_snapshot",
]
