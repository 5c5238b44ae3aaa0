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
    DeviceDgiFlow,
    DeviceEdgeFlow,
    DeviceGaeFlow,
    DeviceGraphTables,
    DeviceKGFlow,
    DeviceLayerwiseFlow,
    DeviceRelationFlow,
    DeviceSageFlow,
    DeviceUnsupSageFlow,
    DeviceWalkFlow,
    DeviceWholeGraphFlow,
)
from euler_tpu_torch.dataflow.layerwise import LayerwiseBatch, LayerwiseDataFlow  # noqa: F401
from euler_tpu_torch.dataflow.relation import RelationDataFlow, RelMiniBatch  # noqa: F401
from euler_tpu_torch.dataflow.walk import gen_pair  # noqa: F401
from euler_tpu_torch.dataflow.whole import (  # noqa: F401
    FullGraphFlow,
    GraphBatch,
    WholeGraphDataFlow,
    graph_label_batches,
)
