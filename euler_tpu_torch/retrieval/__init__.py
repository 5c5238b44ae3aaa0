"""Embedding retrieval serving: exact filtered top-K over a corpus staged
on the device, sharded across servers and hot-swapped between versions
(counterpart: euler_tpu/retrieval/).

  corpus.py  immutable versioned EmbeddingCorpus (checkpoint → paged
             table + id map + attribute columns)
  topk.py    bucket-padded brute-force top-K through the
             `paged_topk_score` and `paged_topk_select` kernels, the
             independent NumPy oracle, the canonical-order shard merge
  server.py  RetrievalServer — retrieve/corpus_stats/reload_corpus wire
             verbs over _PoolServer, dual-engine version pinning
  router.py  RetrievalRouter — concurrent fan-out, hedging, heap merge,
             mixed-version convergence
  client.py  RetrievalClient — fleet facade (query + stats + rolling
             hot swap)

`python -m euler_tpu_torch.tools.retrieve` is the CLI.
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
