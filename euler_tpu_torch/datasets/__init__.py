from euler_tpu_torch.datasets.synthetic import (  # noqa: F401
    graph_with_degrees,
    random_graph,
    shard_arrays,
    skewed_weighted_graph,
    synthetic_meta,
)
from euler_tpu_torch.datasets.quality import (  # noqa: F401
    cora_like_json,
    fb15k_like,
    mutag_like_json,
    products_like_graph,
)
from euler_tpu_torch.datasets.base import Dataset  # noqa: F401
from euler_tpu_torch.datasets.catalog import get_dataset  # noqa: F401
