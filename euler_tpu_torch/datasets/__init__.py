from euler_tpu_torch.datasets.synthetic import (  # noqa: F401
    graph_with_degrees,
    random_graph,
    shard_arrays,
    skewed_weighted_graph,
    synthetic_meta,
)
from euler_tpu_torch.datasets.quality import products_like_graph  # noqa: F401
