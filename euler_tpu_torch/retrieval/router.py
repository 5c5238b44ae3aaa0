"""RetrievalRouter — fan-out / merge half of fleet retrieval
(counterpart: euler_tpu/retrieval/router.py, copied whole).

A query hits every corpus row shard concurrently (`_DaemonExecutor`,
the same daemon-worker executor the graph client overlaps RPCs with),
each shard answers its own exact top-k, and the router fuses them with
`merge_topk` — a k-way heap merge in the canonical (score desc, id asc)
order, so the fleet answer is bit-identical to a single-shard search
over the union corpus (tests/test_torch_retrieval_front.py).

Two reliability layers ride on top of `RemoteShard.call`'s built-in
failover/quarantine/deadline envelope:

  * Hedging (opt-in via `hedge_ms`): the primary attempt is pinned to a
    replica drawn from the shard's rotation and runs on the shard's OWN
    executor (a leaf task — nesting it into the router pool would
    deadlock the query path once outer fan-out tasks fill every worker);
    an answer still outstanding after the hedge delay gets a second
    attempt pinned to a DIFFERENT replica; first success wins. Hedges
    are capped by a `RetryBudget` that un-hedged successes refill
    (gRPC retry-throttle shape), so a systematically slow fleet degrades
    to plain fan-out instead of doubling its own load — and recovers
    hedging once it answers in time again. Typed server errors
    (`RpcError` subclasses) raise immediately — they are deterministic
    verdicts, not tail latency.
  * Version convergence: shard answers carry the corpus version they
    were scored against. A merge across MIXED versions (a rolling
    `reload_corpus` caught mid-flight) would be meaningless, so the
    router re-queries the mismatched shards pinned (trailing `version`
    arg) to the MINIMUM version seen — the one every shard can still
    serve, because swapped servers retain the outgoing engine as
    `_prev`. Version strings order lexicographically by checkpoint step
    (corpus.py), so `min` is "oldest". If a pin races a second swap the
    server answers a deterministic "corpus version skew" error and the
    router starts over with a fresh fan-out, bounded by
    MAX_VERSION_ROUNDS.
"""

from __future__ import annotations

import concurrent.futures
import json
import time

import numpy as np

from euler_tpu_torch.distributed.client import _DaemonExecutor
from euler_tpu_torch.distributed.errors import RpcError
from euler_tpu_torch.distributed.retry import RetryBudget
from euler_tpu_torch.retrieval.topk import merge_topk


class RetrievalRouter:
    """Exact global top-k over a list of `RemoteShard` handles."""

    MAX_VERSION_ROUNDS = 4

    def __init__(
        self,
        shards: list,
        hedge_ms: float | None = None,
        hedge_budget: float = 8.0,
    ):
        self.shards = list(shards)
        self.hedge_ms = hedge_ms
        self._hedge_budget = RetryBudget(cap=float(hedge_budget))
        self._pool = _DaemonExecutor(
            max(4, 2 * len(self.shards)), "retrieval-router"
        )
        # telemetry (GIL-racy increments fine): the bench retrieval lane
        # reads fanout_s/merge_s to report per-shard merge overhead
        self.queries = 0
        self.hedges = 0
        self.version_rounds = 0
        self.fanout_s = 0.0
        self.merge_s = 0.0

    def close(self):
        self._pool.close()

    # -- per-shard call with optional hedge ------------------------------

    def _one(self, sh, values, deadline_s, prefer=None):
        return sh.call(
            "retrieve", list(values), deadline_s=deadline_s, prefer=prefer
        )

    def _shard_retrieve(self, sh, values, deadline_s):
        # ONE snapshot of the COW replica tuple: the hedge-or-not decision
        # and the hedge-target pick below must see the same rotation (a
        # sync_replicas swap between two reads could hedge against a set
        # the primary pick never saw)
        reps = sh.replicas
        if self.hedge_ms is None or len(reps) < 2:
            return self._one(sh, values, deadline_s)
        # Primary + hedge go to the SHARD's own executor (leaf RPCs that
        # submit nothing further), never self._pool: the router pool runs
        # the outer _shard_retrieve tasks, and nesting blocking children
        # into the same fixed-size pool deadlocks as soon as outer tasks
        # fill every worker and wait on inner futures that can never be
        # scheduled. The shard pool only ever runs tasks that complete on
        # their own, so waiting on its futures always makes progress.
        prim_rep = sh._pick()  # honors quarantine, advances the rotation
        prim_addr = (prim_rep.host, prim_rep.port)
        primary = sh.submit(
            "retrieve", list(values), deadline_s=deadline_s,
            prefer=prim_addr,
        )
        try:
            out = primary.result(timeout=self.hedge_ms / 1e3)
            self._hedge_budget.on_success()  # un-hedged success refills
            return out
        except concurrent.futures.TimeoutError:
            pass
        except RpcError:
            raise  # deterministic server verdict: hedging can't change it
        if not self._hedge_budget.try_spend():
            out = primary.result()
            self._hedge_budget.on_success()  # slow but un-hedged: refill
            return out
        self.hedges += 1
        # hedge a replica OTHER than the one the primary was pinned to —
        # knowable exactly because the pin above froze the primary's
        # target, instead of re-reading the shared round-robin cursor
        # (bumped by every concurrent call, so under load it can point
        # right back at the slow replica)
        others = [r for r in reps if (r.host, r.port) != prim_addr]
        nxt = others[self.hedges % len(others)] if others else prim_rep
        hedge = sh.submit(
            "retrieve", list(values), deadline_s=deadline_s,
            prefer=(nxt.host, nxt.port),
        )
        pending = {primary, hedge}
        first_err: Exception | None = None
        while pending:
            done, pending = concurrent.futures.wait(
                pending, return_when=concurrent.futures.FIRST_COMPLETED
            )
            for f in done:
                e = f.exception()
                if e is None:
                    return f.result()
                if isinstance(e, RpcError):
                    raise e  # typed verdict: same answer on any replica
                if first_err is None:
                    first_err = e
        raise first_err  # both attempts exhausted transport retries

    # -- the query path --------------------------------------------------

    def _fan_out(self, values, deadline_s):
        futs = [
            self._pool.submit(self._shard_retrieve, sh, values, deadline_s)
            for sh in self.shards
        ]
        # .result() re-raises typed errors / exhausted transports — a
        # failed shard fails the query (partial merges are silent wrong
        # answers, the one thing this subsystem must never produce)
        return [f.result() for f in futs]

    def retrieve(
        self,
        q: np.ndarray,
        k: int,
        dnf=None,
        deadline_s: float | None = None,
        tenant: str | None = None,
    ):
        """Global top-k: (ids u64[B, k], scores f32[B, k],
        valid bool[B, k], version str) — every answered row scored
        against ONE corpus version, even mid-hot-swap."""
        q = np.ascontiguousarray(q, dtype=np.float32)
        dnf_json = json.dumps(dnf) if dnf is not None else None
        base = [q, int(k), dnf_json, tenant, None]
        self.queries += 1
        t0 = time.monotonic()
        answers = self._fan_out(base, deadline_s)
        versions = sorted({a[3] for a in answers})
        rounds = 0
        while len(versions) > 1:
            rounds += 1
            self.version_rounds += 1
            if rounds > self.MAX_VERSION_ROUNDS:
                raise RpcError(
                    "retrieval fleet corpus versions never converged "
                    f"after {rounds - 1} rounds: {versions}"
                )
            pin = versions[0]  # min == oldest == still held as _prev
            try:
                for i, a in enumerate(answers):
                    if a[3] != pin:
                        answers[i] = self._shard_retrieve(
                            self.shards[i],
                            [q, int(k), dnf_json, tenant, pin],
                            deadline_s,
                        )
            except RpcError as e:
                if "corpus version skew" not in str(e):
                    raise
                # the pin lost a race with another swap: re-sample what
                # the fleet serves now and try to converge on that
                answers = self._fan_out(base, deadline_s)
            versions = sorted({a[3] for a in answers})
        t1 = time.monotonic()
        parts = [
            (
                np.asarray(a[0], dtype=np.uint64),
                np.asarray(a[1], dtype=np.float32),
                np.asarray(a[2]) != 0,
            )
            for a in answers
        ]
        ids, scores, valid = merge_topk(parts, k)
        t2 = time.monotonic()
        self.fanout_s += t1 - t0
        self.merge_s += t2 - t1
        return ids, scores, valid, versions[0]

    def stats(self) -> dict:
        return {
            "queries": self.queries,
            "hedges": self.hedges,
            "version_rounds": self.version_rounds,
            "fanout_s": round(self.fanout_s, 6),
            "merge_s": round(self.merge_s, 6),
        }
