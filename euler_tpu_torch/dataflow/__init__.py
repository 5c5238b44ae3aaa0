from euler_tpu_torch.dataflow.base import (  # noqa: F401
    Block,
    DataFlow,
    MiniBatch,
    fanout_block,
    gather_unique,
    hydrate_blocks,
    to_device,
    upgrade_lean_host,
)
from euler_tpu_torch.dataflow.sage import FullNeighborDataFlow, SageDataFlow  # noqa: F401
from euler_tpu_torch.dataflow.device import (  # noqa: F401
    DeviceEdgeFlow,
    DeviceGraphTables,
    DeviceKGFlow,
    DeviceSageFlow,
    DeviceUnsupSageFlow,
    DeviceWalkFlow,
)
from euler_tpu_torch.dataflow.walk import gen_pair  # noqa: F401
from euler_tpu_torch.dataflow.whole import FullGraphFlow  # noqa: F401
