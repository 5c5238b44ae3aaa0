"""ServingRouter — N replicated ModelServers behind one predict() surface
(counterpart: euler_tpu/serving/router.py, copied whole: the same hash
ring picks the same replica for the same ids).

One ModelServer is a single process: one batcher's throughput is the
fleet's throughput, and one straggling device step IS the p99. The
router scales serving the way the reference scales query serving — a
fixed fleet of workers behind a shared frontier (grpc_worker_service.cc:
48-96) — but lives CLIENT-side (the gRPC load-balancing shape): no proxy
hop, no single choke point; a fleet is just a replica address list.

Pieces:

  Routing policies (pluggable, `POLICIES`):
    consistent_hash — requests hash onto a vnode ring built from replica
        ADDRESSES, so the same ids land on the same replica (bucket and
        cache affinity) and the assignment is stable under replica-list
        order — two routers over the same fleet agree without talking.
    least_loaded — replicas ranked by the router's own in-flight count,
        then the fleet's `server_stats` load signals (queue_depth, EWMA
        batch latency) polled on a short TTL.

  Hedged requests: when the primary attempt has not answered after a
    p95-tracked delay (EULER_TPU_HEDGE_MS pins it), the SAME request is
    re-issued to the next replica in the preference order and the first
    answer wins — bit-identical to the unhedged answer by construction,
    because every replica serves the same checkpoint through the same
    deterministic padded-bucket programs. A RetryBudget-shaped token
    bucket (distributed/retry.py) caps hedges: each hedge spends a
    token, each success refills a fraction, and a dry bucket means the
    fleet is degraded — more duplicate load is exactly wrong, so hedging
    stops (EULER_TPU_HEDGE_BUDGET caps the bucket).

  Failover: transport faults quarantine the replica and the attempt
    moves on — a killed replica costs one connect error, not an error
    surfaced to the caller. Typed server verdicts (OverloadError,
    DeadlineExceeded) are deterministic decisions and NEVER cause
    failover; they surface unless a concurrent hedge genuinely answers.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from bisect import bisect_right
from collections import deque
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import wait as futures_wait

import numpy as np

from euler_tpu_torch.distributed.client import _DaemonExecutor, _Replica
from euler_tpu_torch.distributed.errors import (
    DeadlineExceeded,
    OverloadError,  # noqa: F401 (re-export: the quota verdict callers catch)
    RpcError,
)
from euler_tpu_torch.distributed.retry import RetryBudget, default_timeout_s

# fallback hedge delay until the latency window has enough samples for a
# real p95 (and the floor under a degenerate all-equal window)
_HEDGE_DEFAULT_S = 0.05
_HEDGE_MIN_SAMPLES = 20


def hedge_ms_from_env() -> float | None:
    """EULER_TPU_HEDGE_MS: pinned hedge delay (None = p95-tracked)."""
    v = os.environ.get("EULER_TPU_HEDGE_MS")
    return float(v) if v else None


class _ReplicaState:
    """One replica's routing state. Mutable fields are written under the
    router lock only; `replica` owns its (thread-local) sockets."""

    __slots__ = (
        "host", "port", "index", "replica",
        "inflight", "queue_depth", "ewma_batch_ms", "bad_until",
    )

    def __init__(self, host: str, port: int, index: int):
        self.host = str(host)
        self.port = int(port)
        self.index = index
        self.replica = _Replica(self.host, self.port, shard=index)
        self.inflight = 0  # router-local in-flight attempts
        self.queue_depth = 0  # last polled server_stats load signals
        self.ewma_batch_ms = 0.0
        self.bad_until = 0.0  # monotonic quarantine horizon

    def key(self) -> str:
        return f"{self.host}:{self.port}"


class RoutingPolicy:
    """Replica preference order per request: order(ids) returns every
    replica, most-preferred first — slot 0 is the primary, slot 1 the
    hedge target, the rest the failover chain."""

    name = "?"
    uses_load_signals = False

    def __init__(self, states: list[_ReplicaState]):
        self.states = states

    def order(self, ids: np.ndarray) -> list[_ReplicaState]:
        raise NotImplementedError


class ConsistentHashPolicy(RoutingPolicy):
    """Vnode hash ring keyed by replica ADDRESS: assignment depends only
    on (request ids, fleet membership), never on replica-list order —
    the property the cache/bucket-affinity claim rests on."""

    name = "consistent_hash"
    VNODES = 64

    def __init__(self, states):
        super().__init__(states)
        points = []
        for st in states:
            for v in range(self.VNODES):
                points.append((self._hash(f"{st.key()}#{v}".encode()), st))
        points.sort(key=lambda t: t[0])
        self._ring = [h for h, _ in points]
        self._owners = [st for _, st in points]

    @staticmethod
    def _hash(raw: bytes) -> int:
        return int.from_bytes(
            hashlib.blake2b(raw, digest_size=8).digest(), "big"
        )

    def order(self, ids):
        key = self._hash(np.ascontiguousarray(ids).tobytes())
        start = bisect_right(self._ring, key) % len(self._ring)
        out, seen = [], set()
        for i in range(len(self._owners)):
            st = self._owners[(start + i) % len(self._owners)]
            if id(st) not in seen:
                seen.add(id(st))
                out.append(st)
                if len(out) == len(self.states):
                    break
        return out


class LeastLoadedPolicy(RoutingPolicy):
    """Rank by the freshest signal first: the router's own in-flight
    count (always current), then the polled queue depth and EWMA batch
    latency, with the replica address as a list-order-stable tiebreak."""

    name = "least_loaded"
    uses_load_signals = True

    def order(self, ids):
        return sorted(
            self.states,
            key=lambda st: (
                st.inflight,
                st.queue_depth,
                st.ewma_batch_ms,
                st.key(),
            ),
        )


POLICIES = {
    ConsistentHashPolicy.name: ConsistentHashPolicy,
    LeastLoadedPolicy.name: LeastLoadedPolicy,
}


class ServingRouter:
    """Routes predict() over a fleet of ModelServer replicas."""

    def __init__(
        self,
        replicas,
        policy="consistent_hash",
        deadline_ms: float | None = None,
        hedge: bool = True,
        hedge_ms: float | None = None,
        hedge_budget: RetryBudget | None = None,
        attempt_timeout_s: float = 10.0,
        quarantine_s: float = 2.0,
        stats_refresh_s: float = 0.5,
        workers: int | None = None,
    ):
        """replicas: [(host, port), ...] — one entry per ModelServer.
        policy: name in POLICIES, or a RoutingPolicy subclass.
        hedge_ms: pinned hedge delay; None tracks the p95 of this
        router's own latency window (EULER_TPU_HEDGE_MS overrides)."""
        replicas = list(replicas)
        if not replicas:
            raise ValueError("need at least one replica")
        self._states = [
            _ReplicaState(h, p, i) for i, (h, p) in enumerate(replicas)
        ]
        if isinstance(policy, str):
            try:
                policy = POLICIES[policy]
            except KeyError:
                raise ValueError(
                    f"unknown routing policy {policy!r}"
                    f" (have: {sorted(POLICIES)})"
                ) from None
        self.policy: RoutingPolicy = policy(self._states)
        self.deadline_ms = deadline_ms
        self.hedge_enabled = bool(hedge) and len(self._states) > 1
        self.hedge_ms = hedge_ms if hedge_ms is not None else hedge_ms_from_env()
        self._hedge_budget = hedge_budget or RetryBudget(
            cap=float(os.environ.get("EULER_TPU_HEDGE_BUDGET", 16.0))
        )
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.quarantine_s = float(quarantine_s)
        self.stats_refresh_s = float(stats_refresh_s)
        self._lock = threading.Lock()
        self._lat_ms: deque = deque(maxlen=512)  # bounded p95 window
        self._stats_next = 0.0
        self._ex = _DaemonExecutor(
            workers or max(16, 4 * len(self._states)), "serving-router"
        )
        # telemetry (reads under the lock via stats())
        self.requests = 0
        self.rpc_count = 0
        self.failovers = 0
        self.hedges = 0
        self.hedges_won = 0
        self.hedges_denied = 0

    # -- surface ---------------------------------------------------------

    def predict(
        self, node_ids, deadline_ms: float | None = None, tenant=None
    ) -> np.ndarray:
        """Embeddings for node_ids ([n, D]) from the first replica to
        answer; raises OverloadError / DeadlineExceededError verdicts,
        RpcError when every replica is unreachable."""
        ids = np.asarray(node_ids, dtype=np.uint64).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty id list")
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        budget_s = float(dl) / 1e3 if dl is not None else default_timeout_s()
        deadline = time.monotonic() + budget_s
        if self.policy.uses_load_signals:
            self._refresh_load()
        order = self.policy.order(ids)
        with self._lock:
            self.requests += 1
        # futures -> is_hedge; the primary attempt owns the full failover
        # chain, a hedge starts one replica further along it
        futs = {self._ex.submit(self._attempt, order, 0, ids, tenant,
                                deadline): False}
        if self.hedge_enabled:
            delay = min(
                self._hedge_delay_s(), max(deadline - time.monotonic(), 0.0)
            )
            done, _ = futures_wait(
                set(futs), timeout=delay, return_when=FIRST_COMPLETED
            )
            if not done:
                if self._hedge_budget.try_spend():
                    with self._lock:
                        self.hedges += 1
                    futs[self._ex.submit(
                        self._attempt, order, 1, ids, tenant, deadline
                    )] = True
                else:
                    with self._lock:
                        self.hedges_denied += 1
        return self._harvest(futs, deadline)

    def _harvest(self, futs: dict, deadline: float) -> np.ndarray:
        """First successful attempt wins (bit-identical across replicas,
        so WHICH one is immaterial); errors surface only when no attempt
        succeeds — typed verdicts first, they are the real decision."""
        typed_err = None
        last_err = None
        pending = dict(futs)
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            done, _ = futures_wait(
                set(pending), timeout=remaining,
                return_when=FIRST_COMPLETED,
            )
            if not done:
                break
            for f in done:
                is_hedge = pending.pop(f)
                try:
                    out = f.result()
                except RpcError as e:
                    typed_err = typed_err or e
                    last_err = e
                except Exception as e:
                    last_err = e
                else:
                    if is_hedge:
                        with self._lock:
                            self.hedges_won += 1
                    return out
        if typed_err is not None:
            raise typed_err
        if last_err is not None:
            raise last_err
        raise DeadlineExceeded(
            "router: predict budget exhausted with attempts in flight"
        )

    def _attempt(self, order, start, ids, tenant, deadline):
        """One attempt chain: walk the preference order from `start`,
        failing over on transport faults (quarantine + next replica),
        raising typed server verdicts immediately."""
        now = time.monotonic()
        seq = order[start:] + order[:start]
        live = [st for st in seq if st.bad_until <= now]
        # all-quarantined fallback: least-recently-failed first (timed
        # revival — a fleet-wide blip must not strand the router)
        seq = live + sorted(
            (st for st in seq if st.bad_until > now),
            key=lambda st: st.bad_until,
        )
        err = None
        for st in seq:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            with self._lock:
                st.inflight += 1
                self.rpc_count += 1
            t0 = time.monotonic()
            try:
                out = st.replica.call(
                    "predict",
                    [ids, None, tenant],
                    timeout_s=min(remaining, self.attempt_timeout_s),
                    budget_ms=remaining * 1e3,
                )
                with self._lock:
                    self._lat_ms.append((time.monotonic() - t0) * 1e3)
                self._hedge_budget.on_success()
                return out[0]
            except RpcError:
                raise  # deterministic server verdict: never failover
            except (OSError, ConnectionError, ValueError) as e:
                err = e
                st.replica.drop()
                with self._lock:
                    st.bad_until = time.monotonic() + self.quarantine_s
                    self.failovers += 1
            finally:
                with self._lock:
                    st.inflight -= 1
        if err is not None:
            raise RpcError(
                f"router: all {len(seq)} replicas failed: {err}"
            )
        raise DeadlineExceeded(
            f"router: predict budget exhausted after {len(seq)} replicas"
        )

    # -- hedge delay -----------------------------------------------------

    def _hedge_delay_s(self) -> float:
        if self.hedge_ms is not None:
            return float(self.hedge_ms) / 1e3
        with self._lock:
            window = list(self._lat_ms)
        if len(window) < _HEDGE_MIN_SAMPLES:
            return _HEDGE_DEFAULT_S
        return max(float(np.percentile(window, 95)) / 1e3, 1e-3)

    # -- load signals ----------------------------------------------------

    def _refresh_load(self) -> None:
        """Refresh the fleet's server_stats load signals at most every
        stats_refresh_s — asynchronously, so ranking never waits on a
        slow or dead replica."""
        now = time.monotonic()
        with self._lock:
            if now < self._stats_next:
                return
            self._stats_next = now + self.stats_refresh_s
        for st in self._states:
            self._ex.submit(self._poll_one, st)

    def _poll_one(self, st: _ReplicaState) -> None:
        try:
            out = st.replica.call("server_stats", [], timeout_s=1.0)
            d = json.loads(out[0])
        except Exception:
            return  # dead replicas are handled by the predict-path
            # quarantine; stale signals just rank it where it was
        with self._lock:
            st.queue_depth = int(d.get("queue_depth", 0))
            st.ewma_batch_ms = float(d.get("ewma_batch_ms", 0.0))

    # -- fleet operator surface ------------------------------------------

    def fleet_stats(self, timeout_s: float = 2.0) -> dict:
        """Fresh server_stats from EVERY replica, keyed "host:port";
        unreachable replicas map to {"error": ...} instead of hiding."""
        out = {}
        for st in self._states:
            try:
                out[st.key()] = json.loads(
                    st.replica.call("server_stats", [],
                                    timeout_s=timeout_s)[0]
                )
            except Exception as e:
                st.replica.drop()
                out[st.key()] = {"error": repr(e)[:200]}
        return out

    def ping_all(self, timeout_s: float = 2.0) -> dict:
        """Per-replica liveness, keyed "host:port"."""
        out = {}
        for st in self._states:
            try:
                out[st.key()] = (
                    st.replica.call("ping", [], timeout_s=timeout_s) == [0]
                )
            except Exception:
                st.replica.drop()
                out[st.key()] = False
        return out

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            window = list(self._lat_ms)
            return {
                "policy": self.policy.name,
                "replicas": {
                    st.key(): {
                        "inflight": st.inflight,
                        "queue_depth": st.queue_depth,
                        "ewma_batch_ms": st.ewma_batch_ms,
                        "quarantined": st.bad_until > now,
                    }
                    for st in self._states
                },
                "requests": self.requests,
                "rpc_count": self.rpc_count,
                "failovers": self.failovers,
                "hedges": self.hedges,
                "hedges_won": self.hedges_won,
                "hedges_denied": self.hedges_denied,
                "hedge_tokens": self._hedge_budget.tokens,
                "p95_ms": (
                    round(float(np.percentile(window, 95)), 3)
                    if window else None
                ),
            }

    def close(self):
        self._ex.close()
        for st in self._states:
            st.replica.drop()
