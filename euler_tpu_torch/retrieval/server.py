"""The scoring unit of a retrieval server
(counterpart: euler_tpu/retrieval/server.py:54-87, `_CorpusEngine`).

A `_CorpusEngine` is one immutable (corpus shard, staged TopKIndex,
bounded DNF-mask cache) unit; a server publishes it by one reference
assignment and swaps it whole on a corpus reload. Only the engine is
ported so far: `RetrievalServer` (the `retrieve`/`corpus_stats`/
`reload_corpus` wire verbs), the router, the client and
`tools/retrieve.py` are wire code and come with the rest of serving
(ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import collections
import json
import threading

import numpy as np

from euler_tpu_torch.retrieval.corpus import EmbeddingCorpus
from euler_tpu_torch.retrieval.topk import TopKIndex


class _CorpusEngine:
    """Immutable serving unit: one corpus shard, its staged top-K index,
    and a bounded cache of DNF candidate masks (deterministic per corpus
    version, so caching is pure memoization)."""

    MASK_CACHE = 64

    def __init__(self, corpus: EmbeddingCorpus, impl: str = "auto", device=None):
        self.corpus = corpus
        self.index = TopKIndex(corpus, impl=impl, device=device)
        self._masks: collections.OrderedDict = collections.OrderedDict()
        self._mask_lock = threading.Lock()

    def warm(self, k: int):
        self.index.warmup(k)
        return self

    def mask_for(self, dnf_json: str | None):
        if not dnf_json:
            return None
        with self._mask_lock:
            mask = self._masks.get(dnf_json)
            if mask is not None:
                self._masks.move_to_end(dnf_json)
                return mask
        mask = self.corpus.condition_mask(json.loads(dnf_json))
        with self._mask_lock:
            self._masks[dnf_json] = mask
            while len(self._masks) > self.MASK_CACHE:
                self._masks.popitem(last=False)
        return mask

    def retrieve(self, q: np.ndarray, k: int, dnf_json: str | None):
        return self.index.search(q, k, self.mask_for(dnf_json))
