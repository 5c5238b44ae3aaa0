"""Remote client transport: per-address replica pools with failover
(counterpart: euler_tpu/distributed/client.py:47-200, :223-565).

The reference's client stack (euler/client/): `RpcManager` keeps round-robin
replica channels per shard with bad-host quarantine + timed revival
(rpc_manager.h:66-124) and retries calls up to 10× (rpc_client.h:32-66).
`RemoteShard` reproduces that contract over the wire protocol — and adds
the discipline around the retry loop: a per-call deadline that propagates
on the wire (EULER_TPU_RPC_TIMEOUT_S; socket timeouts derive from the
remaining budget), exponential backoff with deterministic seeded jitter,
and a per-shard retry budget that fails fast instead of joining a retry
storm (distributed/retry.py). Typed server verdicts (`RpcError` and its
subclasses) are never transport-retried.

Only the transport is ported: `_DaemonExecutor`, `_Replica` and
`RemoteShard`'s replicas, pick, `call` (retry, failover, deadline and
envelope degrade), `submit`, the counters and `close` — what the serving
client and router run, and the retrieval front end will. The graph verbs, the read cache and
`connect` (a `Graph` facade over remote shards) belong to the
distributed graph tier: ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time

from euler_tpu_torch.distributed import chaos, wire
from euler_tpu_torch.distributed.errors import (  # noqa: F401 (re-exports)
    DeadlineExceeded,
    OverloadError,
    RpcError,
    from_wire,
)
from euler_tpu_torch.distributed.retry import (
    RetryBudget,
    RetryPolicy,
    default_timeout_s,
)


class _DaemonExecutor:
    """Minimal bounded executor on daemon threads.

    concurrent.futures.ThreadPoolExecutor joins its (non-daemon) workers
    at interpreter exit — a worker stuck in a connect-retry loop against
    torn-down shard servers would stall process exit for minutes. Daemon
    workers + no global join means abandoned in-flight futures die with
    the process, which is exactly right for fire-and-forget RPC overlap."""

    def __init__(self, max_workers: int, name: str):
        import queue as queue_mod

        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._threads = [
            threading.Thread(
                target=self._work, daemon=True, name=f"{name}-{i}"
            )
            for i in range(max_workers)
        ]
        for t in self._threads:
            t.start()

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as e:
                fut.set_exception(e)

    def submit(self, fn, *args):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, fn, args))
        return fut

    def close(self):
        # cancel still-pending jobs FIRST: a sentinel enqueued behind a
        # pending job would let the worker exit while the job's future
        # stays forever unresolved — a waiter on a submitted-but-unstarted
        # RPC would hang until process exit
        import queue as queue_mod

        while True:
            try:
                item = self._q.get_nowait()
            except queue_mod.Empty:
                break
            if item is None:
                continue
            item[0].cancel()  # pending Future -> CancelledError for waiters
        for _ in self._threads:
            self._q.put(None)


class _Replica:
    def __init__(
        self,
        host: str,
        port: int,
        shard: int | None = None,
        counters: tuple | None = None,
    ):
        self.host = host
        self.port = port
        self.shard = shard  # chaos-plan matching + diagnostics only
        self.bad_until = 0.0
        # optional (bytes_out Counter, bytes_in Counter) pair shared
        # across the owning shard handle's replicas — per-verb wire
        # bytes, GIL-racy increments fine (telemetry, not an invariant)
        self.counters = counters
        self._local = threading.local()

    def _sock(self, timeout_s: float | None = None) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection(
                (self.host, self.port),
                timeout=timeout_s if timeout_s is not None
                else default_timeout_s(),
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def drop(self):
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None

    def call(
        self,
        op: str,
        values: list,
        timeout_s: float | None = None,
        budget_ms: float | None = None,
    ) -> list:
        """One attempt: no retries at this layer.

        timeout_s bounds the socket (connect/send/recv) — derived by the
        caller from its remaining deadline; budget_ms (when the peer
        speaks the envelope) ships that remaining budget so the server
        can reject already-expired work before dispatch."""
        plan = chaos.active_plan()
        if plan is not None:
            # may raise the transport error the fault models — BEFORE any
            # bytes move, so the server's state is untouched and the
            # retried call (same client-drawn seed) replays exactly
            plan.apply_client(
                self.shard, (self.host, self.port), op, timeout_s
            )
        sock = self._sock(timeout_s)
        sock.settimeout(
            timeout_s if timeout_s is not None else default_timeout_s()
        )
        wire_op = (
            op if budget_ms is None else wire.wrap_deadline(op, budget_ms)
        )
        # vectored send + borrow decode: request arrays ride as iovecs,
        # response arrays slice the (per-frame, never-mutated) recv
        # buffer — zero staging copies on either direction of the wire
        frame = wire.encode_vectored(wire_op, values)
        if self.counters is not None:
            self.counters[0][op] += wire.frame_nbytes(frame)
        wire.send_frame(sock, frame)
        payload = wire.read_frame(sock)
        if payload is not None and self.counters is not None:
            self.counters[1][op] += 4 + len(payload)
        if payload is None:
            # clean EOF — the server closed this connection (shutdown or
            # restart): a transport failure, so the caller fails over,
            # unlike an "err" status which is deterministic
            raise ConnectionError("connection closed by peer")
        status, result = wire.decode(payload, borrow=True)
        if status == "err":
            raise from_wire(result[0])
        return result




class RemoteShard:
    """The transport of one shard served by N replicas: round-robin
    picks with quarantine, and one logical `call` with retries."""

    RETRIES = 10
    QUARANTINE_S = 5.0

    def __init__(
        self,
        shard: int,
        replicas: list[tuple[str, int]],
        retry_policy: RetryPolicy | None = None,
    ):
        self.shard = shard
        # per-verb wire bytes this handle put on / read off the socket
        # (client half of the byte-budget story; the server half lives
        # in the server's wire_bytes_in/out). Shared by every replica.
        self.wire_bytes_out: collections.Counter = collections.Counter()
        self.wire_bytes_in: collections.Counter = collections.Counter()
        self._counters = (self.wire_bytes_out, self.wire_bytes_in)
        # copy-on-write tuple: readers grab ONE reference and index it;
        # membership changes build a new tuple and swap it in a single
        # assignment under the lock, so _pick never scans a torn list
        self.replicas = tuple(
            _Replica(h, p, shard, self._counters) for h, p in replicas
        )
        self._rr = 0
        self._lock = threading.Lock()
        self._pool = None  # lazy in-flight request executor
        # per-shard jitter stream seeded by shard index: deterministic
        # backoff schedules per shard, distinct across shards
        self.retry_policy = retry_policy or RetryPolicy.from_env(seed=shard)
        self._budget = RetryBudget(
            cap=float(os.environ.get("EULER_TPU_RPC_RETRY_BUDGET", 16.0))
        )
        # sticky downgrade: peers predating the deadline envelope answer
        # it with unknown-op; after one such answer this shard resends
        # plain ops (deadlines then bound only the client side)
        self._deadline_wire = True
        # logical RPCs issued through this shard handle (retries count
        # once); GIL-racy increments are fine for telemetry
        self.rpc_count = 0
        # transport faults that triggered a failover retry — with
        # rpc_count, the proof that recovery was failover, not silent
        # skipping (GIL-racy increments fine: telemetry)
        self.retry_count = 0

    def _executor(self) -> _DaemonExecutor:
        """Bounded executor for overlapped requests: up to
        EULER_TPU_INFLIGHT (default 4) outstanding RPCs per shard, each
        worker thread on its own socket (thread-local in _Replica),
        retry/quarantine preserved."""
        pool = self._pool  # one read: a concurrent close() nulls the attr
        if pool is None:
            with self._lock:
                pool = self._pool
                if pool is None:
                    depth = int(os.environ.get("EULER_TPU_INFLIGHT", "4"))
                    pool = _DaemonExecutor(
                        max(depth, 1), f"shard{self.shard}-rpc"
                    )
                    self._pool = pool
        return pool

    def submit(
        self,
        op: str,
        values: list,
        deadline_s: float | None = None,
        prefer: tuple[str, int] | None = None,
    ):
        """Async call: returns a concurrent.futures.Future of call()'s
        result, overlapping with other in-flight requests to this shard."""
        if deadline_s is None and prefer is None:
            # keep the 2-arg form when unpinned: callers (and tests)
            # that stub call(op, values) keep working
            return self._executor().submit(self.call, op, values)
        return self._executor().submit(
            self.call, op, values, deadline_s, prefer
        )

    def close(self):
        """Stop the in-flight executor workers (idempotent)."""
        # swap under the lock _executor builds under — close() racing a
        # concurrent lazy build must not strand a half-built pool
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    def _pick(self, prefer: tuple[str, int] | None = None) -> _Replica:
        with self._lock:
            reps = self.replicas  # one COW snapshot per pick
            now = time.time()
            if prefer is not None:
                host, port = str(prefer[0]), int(prefer[1])
                for r in reps:
                    if r.host == host and r.port == port:
                        if r.bad_until <= now:
                            return r
                        break  # quarantined primary: fall to round-robin
                else:
                    # a preferred address the pool has never seen — a
                    # replacement replica on a NEW port. Adopt it.
                    r = _Replica(host, port, self.shard, self._counters)
                    self.replicas = reps + (r,)
                    return r
            for _ in range(len(reps)):
                r = reps[self._rr % len(reps)]
                self._rr += 1
                if r.bad_until <= now:
                    return r
            # all quarantined: take the least-recently-failed (timed revival)
            return min(reps, key=lambda r: r.bad_until)

    def call(
        self,
        op: str,
        values: list,
        deadline_s: float | None = None,
        prefer: tuple[str, int] | None = None,
    ) -> list:
        """One logical RPC: failover retries under a deadline.

        `prefer` pins the first attempt to one replica address; a
        quarantined or failing preferred replica falls back to the
        normal round-robin, and an unknown preferred address is adopted
        into the pool.

        Every attempt derives its socket timeout from the remaining
        budget (capped by the policy's per-attempt timeout so one
        blackholed replica can't eat the whole deadline) and ships the
        remaining budget on the wire. Transport faults quarantine the
        replica, spend a retry-budget token, back off with deterministic
        jitter, and fail over; typed server errors (`RpcError` and
        subclasses) raise immediately — retrying a deterministic verdict
        only recomputes it."""
        policy = self.retry_policy
        budget_s = policy.deadline_budget_s(deadline_s)
        deadline = time.monotonic() + budget_s
        attempts = policy.retries or self.RETRIES
        rng = None  # jitter stream built lazily: only failing calls pay
        err: Exception | None = None
        self.rpc_count += 1
        attempt = 0
        while attempt < attempts:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExceeded(
                    f"shard {self.shard}: {op!r} budget ({budget_s:.3f}s)"
                    f" exhausted after {attempt} attempt(s): {err}"
                )
            r = self._pick(prefer)
            try:
                out = r.call(
                    op,
                    values,
                    timeout_s=min(remaining, policy.attempt_timeout_s),
                    budget_ms=(
                        remaining * 1e3 if self._deadline_wire else None
                    ),
                )
                self._budget.on_success()
                return out
            except RpcError as e:
                if self._deadline_wire and self._envelope_unknown(e):
                    # pre-deadline-wire peer: degrade the envelope
                    # (sticky) and resend plain — not a transport retry
                    self._deadline_wire = False
                    continue
                # server-side error: deterministic, don't failover-retry
                raise
            except (OSError, ConnectionError, ValueError) as e:
                err = e
                self.retry_count += 1
                r.drop()
                # quarantine under the pool lock: _pick reads bad_until
                # under it, and an unguarded write could be reordered
                # against a racing reader's round-robin scan
                with self._lock:
                    r.bad_until = time.time() + self.QUARANTINE_S
                attempt += 1
                if attempt >= attempts:
                    break
                if not self._budget.try_spend():
                    raise RpcError(
                        f"shard {self.shard}: retry budget exhausted"
                        f" (replicas failing systematically): {err}"
                    )
                if attempt == 1:  # first retry builds this call's stream
                    rng = policy.call_rng()
                pause = min(
                    policy.backoff_s(attempt - 1, rng),
                    max(deadline - time.monotonic(), 0.0),
                )
                if pause > 0:
                    time.sleep(pause)
        raise RpcError(
            f"shard {self.shard}: all {attempts} attempts failed: {err}"
        )

    @staticmethod
    def _envelope_unknown(e: Exception) -> bool:
        msg = str(e)
        return "unknown op" in msg and wire.DEADLINE_PREFIX in msg


def connect(*args, **kwargs):
    """A `Graph` facade over remote shards: not ported (ROADMAP queue 1
    item 8)."""
    raise NotImplementedError(
        "connect is not ported yet (ROADMAP queue 1 item 8: the distributed "
        "graph tier)"
    )
