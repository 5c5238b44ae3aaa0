from euler_tpu_torch.estimator.estimator import (  # noqa: F401
    Estimator,
    EstimatorConfig,
    make_optimizer,
)
from euler_tpu_torch.estimator.feature_cache import DeviceFeatureCache  # noqa: F401
