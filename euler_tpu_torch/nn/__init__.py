from euler_tpu_torch.nn import metrics  # noqa: F401
from euler_tpu_torch.nn.base_gnn import GNNNet  # noqa: F401
from euler_tpu_torch.nn.embedding import (  # noqa: F401
    embedding_add,
    embedding_moving_average,
    embedding_update,
    partitioned_lookup,
    partitioned_update,
)
from euler_tpu_torch.nn.encoders import Embedding, ShallowEncoder, SparseEmbedding  # noqa: F401
from euler_tpu_torch.nn.heads import SuperviseModel, UnsuperviseModel  # noqa: F401
from euler_tpu_torch.nn.pooling import POOLS, AttentionPool, Pooling, Set2SetPool  # noqa: F401
