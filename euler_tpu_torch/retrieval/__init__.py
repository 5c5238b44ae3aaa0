"""Embedding retrieval: exact filtered top-K over a corpus staged on the
device (counterpart: euler_tpu/retrieval/).

  corpus.py  immutable versioned EmbeddingCorpus (checkpoint → paged
             table + id map + attribute columns)
  topk.py    bucket-padded brute-force top-K through the
             `paged_topk_score` and `paged_topk_select` kernels, the
             independent NumPy oracle, the canonical-order shard merge
  server.py  `_CorpusEngine`, the scoring unit of a server (the wire
             server, router and client are not ported yet)
"""

from euler_tpu_torch.retrieval.corpus import (  # noqa: F401
    INVALID_ID,
    EmbeddingCorpus,
    normalize_rows,
    pad_dim,
    quantize_sig12,
)
from euler_tpu_torch.retrieval.topk import (  # noqa: F401
    TopKIndex,
    bucket_for,
    merge_topk,
    numpy_topk_oracle,
)

__all__ = [
    "INVALID_ID",
    "EmbeddingCorpus",
    "normalize_rows",
    "pad_dim",
    "quantize_sig12",
    "TopKIndex",
    "bucket_for",
    "merge_topk",
    "numpy_topk_oracle",
]
