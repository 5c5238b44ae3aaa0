from euler_tpu_torch.training.checkpoint import (  # noqa: F401
    CheckpointStore,
    is_complete,
    step_of,
    watch_signature,
)
from euler_tpu_torch.training.session import (  # noqa: F401
    AnomalyError,
    HungStepError,
    ResumableSource,
    SessionConfig,
    TrainingError,
    TrainingSession,
    resumable_node_batches,
)
