"""The RPC substrate (counterpart: euler_tpu/distributed/): typed errors,
wire frames, retry and hedge budgets, chaos plans, the membership
registries, the pooled TCP server and the client transport. The graph
tier over it (`GraphService`, `connect`, the read cache, the WAL,
replication and resharding) is not ported: ROADMAP queue 1 item 8."""

from euler_tpu_torch.distributed.chaos import Fault, FaultPlan  # noqa: F401
from euler_tpu_torch.distributed.client import RemoteShard, RpcError, connect  # noqa: F401
from euler_tpu_torch.distributed.errors import (  # noqa: F401
    DeadlineExceeded,
    OverloadError,
)
from euler_tpu_torch.distributed.registry import Registry  # noqa: F401
from euler_tpu_torch.distributed.rendezvous import (  # noqa: F401
    RendezvousServer,
    TcpRegistry,
    make_registry,
)
from euler_tpu_torch.distributed.retry import RetryBudget, RetryPolicy  # noqa: F401
from euler_tpu_torch.distributed.service import GraphService, serve_shard  # noqa: F401
