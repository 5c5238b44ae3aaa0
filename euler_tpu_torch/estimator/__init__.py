from euler_tpu_torch.estimator.estimator import (  # noqa: F401
    Estimator,
    EstimatorConfig,
    OptaxAdagrad,
    edge_batches,
    id_batches,
    make_optimizer,
    node_batches,
    read_sample_ids,
    sample_file_batches,
    stack_batches,
    step_generator,
    unsupervised_batches,
)
from euler_tpu_torch.estimator.feature_cache import DeviceFeatureCache  # noqa: F401
from euler_tpu_torch.estimator.prefetch import Prefetcher  # noqa: F401
