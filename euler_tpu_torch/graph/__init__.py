from euler_tpu_torch.graph.format import read_arrays, write_arrays  # noqa: F401
from euler_tpu_torch.graph.meta import DENSE, FeatureSpec, GraphMeta  # noqa: F401
from euler_tpu_torch.graph.store import DEFAULT_ID, Graph, GraphStore  # noqa: F401
from euler_tpu_torch.graph.builder import build_from_json, convert_json  # noqa: F401
