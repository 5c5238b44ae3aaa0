from euler_tpu_torch.training.checkpoint import (  # noqa: F401
    CheckpointStore,
    is_complete,
    step_of,
)
