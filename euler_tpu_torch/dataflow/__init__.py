from euler_tpu_torch.dataflow.base import (  # noqa: F401
    Block,
    DataFlow,
    MiniBatch,
    fanout_block,
    gather_unique,
    to_device,
)
from euler_tpu_torch.dataflow.sage import SageDataFlow  # noqa: F401
