"""Multi-tenant collective offload service — the shared-NIC layer
(counterpart of ``repro.service``).

The paper's NetFPGA serves *every* host process posting an MPI_Scan through
one device; this package is that front end over :class:`~repro_torch.offload.
OffloadEngine`:

  DescriptorBroker / ServiceClient — wire-encoded descriptor requests from
      many concurrent tenant streams, coalesced into fused engine dispatches
      with bounded queues, admission control, and a deadline flush (broker)
  ServiceTelemetry                 — per-tenant queue depth / latency
      histograms / rejection counts + broker coalescing stats, layered on
      EngineTelemetry (telemetry)
  TuningRegistry / FileTuningRegistry — merged tuning tables keyed by
      backend fingerprint: a pod tunes once, every worker and the broker
      inherit the split/algorithm winners (registry)
"""

from repro_torch.service.broker import (
    DEFAULT_RESULT_TIMEOUT_S,
    AdmissionError,
    BrokerStopped,
    DescriptorBroker,
    QueueFullError,
    ServiceClient,
    ServiceTicket,
)
from repro_torch.service.registry import (
    TUNING_REGISTRY_ENV,
    FileTuningRegistry,
    TuningRegistry,
    default_registry,
)
from repro_torch.service.telemetry import (
    LATENCY_BUCKETS_US,
    LatencyHistogram,
    ServiceTelemetry,
    TenantStats,
)

__all__ = [
    "AdmissionError",
    "BrokerStopped",
    "DEFAULT_RESULT_TIMEOUT_S",
    "DescriptorBroker",
    "FileTuningRegistry",
    "LATENCY_BUCKETS_US",
    "LatencyHistogram",
    "QueueFullError",
    "ServiceClient",
    "ServiceTicket",
    "ServiceTelemetry",
    "TenantStats",
    "TUNING_REGISTRY_ENV",
    "TuningRegistry",
    "default_registry",
]
