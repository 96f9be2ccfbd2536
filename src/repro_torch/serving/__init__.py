"""Serving substrate of the port: tokenizer, seeded sampler, the
continuous-batching engine over a dense or a paged KV store (with lane
fault injection, the in-block finiteness verdict and quarantine), the
fault injector, the carbon-aware scheduler that wires SPROUT's directive
selector into the request path, and the SproutGateway that closes the
control loop between the LP optimizer and one or more regional scheduler
pools; ``serving.chaos`` holds the paired chaos scenario. Exports the
reference's names for the modules the port has
(``repro/serving/__init__.py``)."""
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.kv_cache import PageAllocator
from repro_torch.serving.engine import (InferenceEngine, RequestState,
                                        FinishedRequest)
from repro_torch.serving.faults import (FaultEvent, FaultInjector, FaultPlan,
                                        FaultSpec, no_faults)
from repro_torch.serving.scheduler import (CarbonAwareScheduler,
                                           ReplicaHealth, ServeRequest)
from repro_torch.serving.gateway import (GatewayPool, GatewayStats,
                                         MigrationPlanner, MigrationRecord,
                                         SproutGateway, serve_request_from)

__all__ = ["ByteTokenizer", "SamplingParams", "PageAllocator",
           "InferenceEngine", "RequestState", "FinishedRequest",
           "FaultEvent", "FaultInjector", "FaultPlan", "FaultSpec",
           "no_faults", "CarbonAwareScheduler", "ReplicaHealth",
           "ServeRequest", "GatewayPool", "GatewayStats",
           "MigrationPlanner", "MigrationRecord", "SproutGateway",
           "serve_request_from"]
