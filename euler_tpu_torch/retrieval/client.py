"""RetrievalClient — fleet-facing client for the retrieval protocol
(counterpart: euler_tpu/retrieval/client.py, copied whole).

Topology: `shards` is a list of replica lists, one entry per corpus row
shard (`[[(host, port), ...replicas...], ...]`). Each row shard gets a
`RemoteShard` transport handle (distributed/client.py), which brings the
whole reliability kit for free — deadline-enveloped calls, typed
error pass-through (RpcError subclasses are never failover-retried),
transport-fault quarantine + budgeted failover across that shard's
replicas, and deterministic backoff jitter. Queries go through a
`RetrievalRouter` (router.py): concurrent fan-out to every row shard,
canonical heap merge, mixed-version detection with pinned re-query.

Fleet surfaces (`fleet_stats`/`ping_all`/`reload_all`) address every
replica individually — a reload must reach each server (each holds its
own corpus), and stats from a dead replica show up as an error entry
instead of vanishing (the ServingClient stance).
"""

from __future__ import annotations

import json

import numpy as np

from euler_tpu_torch.distributed.client import RemoteShard, _Replica
from euler_tpu_torch.retrieval.router import RetrievalRouter

# the verbs this module and router.py put on the wire; equal to
# RetrievalServer.HANDLED_VERBS and to the JAX package's table
# (tests/test_torch_retrieval_front.py)
WIRE_VERBS = frozenset(
    {"retrieve", "corpus_stats", "ping", "reload_corpus"}
)


class RetrievalClient:
    """Query + operate a sharded retrieval fleet."""

    WIRE_VERBS = WIRE_VERBS

    def __init__(
        self,
        shards: list,
        hedge_ms: float | None = None,
        hedge_budget: float = 8.0,
    ):
        if not shards:
            raise ValueError("need at least one shard replica list")
        norm = []
        for entry in shards:
            # accept a bare (host, port) as a single-replica shard
            if entry and isinstance(entry[0], (str, bytes)):
                entry = [entry]
            norm.append([tuple(a) for a in entry])
        self.shards = [
            RemoteShard(i, reps) for i, reps in enumerate(norm)
        ]
        # per-replica handles for the fleet surfaces; RemoteShard owns
        # failover, these address one concrete server each
        self._fleet = [
            (i, _Replica(h, p, shard=i))
            for i, reps in enumerate(norm)
            for h, p in reps
        ]
        self.router = RetrievalRouter(
            self.shards, hedge_ms=hedge_ms, hedge_budget=hedge_budget
        )

    def close(self):
        for sh in self.shards:
            for r in sh.replicas:
                r.drop()
        for _, r in self._fleet:
            r.drop()
        self.router.close()

    # -- queries ---------------------------------------------------------

    def retrieve(
        self,
        q: np.ndarray,
        k: int,
        dnf=None,
        deadline_s: float | None = None,
        tenant: str | None = None,
    ):
        """Global top-k over the whole fleet: (ids u64[B, k],
        scores f32[B, k], valid bool[B, k]) in canonical (score desc,
        id asc) order — bit-identical to a single-shard search over the
        union corpus. `dnf` is the graph condition algebra
        (graph/index.py) over the corpus attribute columns."""
        ids, scores, valid, _ = self.router.retrieve(
            q, k, dnf=dnf, deadline_s=deadline_s, tenant=tenant
        )
        return ids, scores, valid

    # -- fleet operations ------------------------------------------------

    def corpus_stats(self, deadline_s: float = 5.0) -> dict:
        """Round-robin stats per row shard (one replica answers each)."""
        out = {}
        for sh in self.shards:
            out[str(sh.shard)] = json.loads(
                sh.call("corpus_stats", [], deadline_s=deadline_s)[0]
            )
        return out

    def fleet_stats(self, deadline_s: float = 5.0) -> dict:
        """Stats from EVERY replica; dead replicas become error entries."""
        out = {}
        for i, r in self._fleet:
            key = f"{i}@{r.host}:{r.port}"
            try:
                out[key] = json.loads(
                    r.call("corpus_stats", [], timeout_s=deadline_s)[0]
                )
            except Exception as e:  # a dead replica must show up
                r.drop()
                out[key] = {"error": repr(e)[:200]}
        return out

    def ping_all(self, deadline_s: float = 2.0) -> dict:
        out = {}
        for i, r in self._fleet:
            key = f"{i}@{r.host}:{r.port}"
            try:
                r.call("ping", [], timeout_s=deadline_s)
                out[key] = True
            except Exception:
                r.drop()
                out[key] = False
        return out

    def reload_all(
        self,
        source: dict | None = None,
        canary_q: np.ndarray | None = None,
        canary_k: int = 4,
        deadline_s: float = 60.0,
    ) -> dict:
        """Rolling hot swap across every replica (shard-major order) —
        the lockstep-with-checkpoint-publish path: each server rebuilds
        from its loader, warms off-path, and flips its engine; routers
        querying mid-roll stay consistent via version-pinned re-query.
        Returns per-replica reports (error entries for dead replicas)."""
        src = json.dumps(source) if source is not None else None
        canary = (
            np.ascontiguousarray(canary_q, dtype=np.float32)
            if canary_q is not None
            else None
        )
        out = {}
        for i, r in self._fleet:
            key = f"{i}@{r.host}:{r.port}"
            try:
                out[key] = json.loads(
                    r.call(
                        "reload_corpus",
                        [src, canary, canary_k],
                        timeout_s=deadline_s,
                    )[0]
                )
            except Exception as e:
                r.drop()
                out[key] = {"error": repr(e)[:200]}
        return out
