from euler_tpu_torch.models.autoencoders import (  # noqa: F401
    DGI,
    GAE,
    dgi_batches,
    gae_batches,
)
from euler_tpu_torch.models.embedding_models import (  # noqa: F401
    SkipGramModel,
    deepwalk_batches,
    line_batches,
)
from euler_tpu_torch.models.graph_clf import GraphClassifier  # noqa: F401
from euler_tpu_torch.models.graphsage import (  # noqa: F401
    GraphSAGESupervised,
    GraphSAGEUnsupervised,
)
from euler_tpu_torch.models.kg import (  # noqa: F401
    TransX,
    kg_batches,
    kg_rank_eval,
    kg_ranking_metrics,
    transx_warm_start,
)
from euler_tpu_torch.models.layerwise_models import LayerwiseGCN  # noqa: F401
from euler_tpu_torch.models.rgcn import RGCNSupervised  # noqa: F401
from euler_tpu_torch.models.scalable import ScalableGNN, ScalableTrainer  # noqa: F401
