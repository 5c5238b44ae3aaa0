"""Online inference serving: micro-batched, admission-controlled GNN
model serving — single replica or a routed fleet
(counterpart: euler_tpu/serving/__init__.py).

    InferenceRuntime — checkpoint + model + dataflow on one device;
                       swap() hot-reloads a checkpoint with zero downtime
    MicroBatcher     — coalesce concurrent requests into one device step
    TenantQuota      — per-tenant admission layered over the bounded queue
    ModelServer      — predict/server_stats/reload wire verbs (pooled TCP)
    ServingClient    — retrying client with typed fast-fail errors,
                       fleet_stats()/ping_all() operator surface
    ServingRouter    — replicated routing (consistent-hash / least-loaded),
                       budget-capped hedging, transport failover

`python -m euler_tpu_torch.tools.serve` is the CLI.
"""

from euler_tpu_torch.serving.batcher import (  # noqa: F401
    DeadlineExceededError,
    MicroBatcher,
    OverloadError,
    TenantQuota,
)
from euler_tpu_torch.serving.client import ServingClient  # noqa: F401
from euler_tpu_torch.serving.router import (  # noqa: F401
    ConsistentHashPolicy,
    LeastLoadedPolicy,
    RoutingPolicy,
    ServingRouter,
)
from euler_tpu_torch.serving.runtime import DEFAULT_BUCKETS, InferenceRuntime  # noqa: F401
from euler_tpu_torch.serving.server import ModelServer  # noqa: F401
