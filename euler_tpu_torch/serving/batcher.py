"""Dynamic micro-batcher: coalesce concurrent predict requests into one
device step (counterpart: euler_tpu/serving/batcher.py, copied whole).

The serving win on accelerators comes from batching concurrent requests
against a persistent compiled program (Ragged Paged Attention, arXiv:
2604.15464): a single 1-row predict wastes almost the whole step, and N
callers each paying their own step serialize on the device. The batcher
holds each arriving request for at most `max_wait_us`, packs every
request that fits under `max_batch` total rows into one runtime.predict
call, and fans the rows back out to the per-request futures.

Overload semantics (admission control): the pending queue is BOUNDED.
When it is full, submit() fast-fails with OverloadError instead of
queueing — callers get backpressure in microseconds, not a hang that
times out downstream (the reference serves recommendation traffic where
a fast degraded answer beats a slow exact one). Requests carry optional
deadlines; a request whose deadline has passed when the dispatcher picks
it up is rejected without touching the device — its device slot goes to
a request that can still use the answer.

Tenant quotas layer OVER the bounded queue: a `TenantQuota` caps each
tenant's admission rate (token bucket) and/or its share of the pending
queue, so one tenant's flood trips ITS typed OverloadError long before
the global queue fills — other tenants never see the overload it caused.

Load signals: `stats()` reads every counter under the batcher lock and
reports `inflight` (admitted, unanswered), `queue_depth`, and
`ewma_batch_ms` (EWMA device-step latency) — the signals a fleet router
ranks replicas by (least-loaded routing, hedge-delay tracking).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

# the serving fast-fail verdicts are the distributed layer's typed errors
# (RpcError subclasses): they cross the wire as an err-frame name prefix
# and are exempt from transport retry at EVERY client, graph or serving
from euler_tpu_torch.distributed.errors import (  # noqa: F401 (re-exports)
    DeadlineExceeded,
    DeadlineExceededError,
    OverloadError,
)

# EWMA weight for the per-batch device-step latency signal: ~last 10
# batches dominate, one straggler step moves the signal but cannot own it
_EWMA_ALPHA = 0.2


class TenantQuota:
    """Per-tenant admission control, layered over the bounded queue.

    Two independent caps, each rejecting with an OverloadError naming
    the tenant (never the global queue error):

      qps         — token bucket: `qps` tokens/s refill up to `burst`;
                    an empty bucket rejects THAT tenant's next request.
      max_pending — at most this many of the tenant's requests admitted
                    but unanswered; a flooding tenant hits its share
                    long before the global queue fills, so every other
                    tenant's admission is untouched.

    Requests with tenant=None bypass the quota (single-tenant callers
    keep the untenanted behavior). EULER_TPU_TENANT_QPS configures the qps
    cap fleet-wide; `from_env()` returns None when nothing is set so
    the no-quota hot path costs nothing.
    """

    # bounded tenant tracking: past this, the stalest idle tenant's
    # bucket is dropped (it re-fills fresh on its next request)
    MAX_TRACKED = 1024

    def __init__(self, qps=None, burst=None, max_pending=None):
        env = os.environ.get("EULER_TPU_TENANT_QPS")
        configured = qps if qps is not None else (float(env) if env else None)
        self.qps = float(configured) if configured is not None else None
        if burst is not None:
            self.burst = float(burst)
        else:
            self.burst = max(1.0, self.qps) if self.qps is not None else 0.0
        self.max_pending = int(max_pending) if max_pending is not None else None
        self._lock = threading.Lock()
        # tenant -> [tokens, last_seen_monotonic, pending, admitted, rejected]
        self._tenants: dict = {}

    def admit(self, tenant: str) -> None:
        """Charge one request to `tenant`; raises a tenant-named
        OverloadError when its quota is exhausted."""
        now = time.monotonic()
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                if len(self._tenants) >= self.MAX_TRACKED:
                    self._evict_idle()
                st = self._tenants[tenant] = [self.burst, now, 0, 0, 0]
            if self.qps is not None:
                st[0] = min(self.burst, st[0] + (now - st[1]) * self.qps)
                st[1] = now
                if st[0] < 1.0:
                    st[4] += 1
                    raise OverloadError(
                        f"tenant {tenant!r}: qps quota exceeded"
                        f" ({self.qps:g}/s, burst {self.burst:g})"
                    )
                st[0] -= 1.0
            else:
                st[1] = now
            if self.max_pending is not None and st[2] >= self.max_pending:
                st[4] += 1
                raise OverloadError(
                    f"tenant {tenant!r}: pending quota exceeded"
                    f" ({self.max_pending} in flight)"
                )
            st[2] += 1
            st[3] += 1

    def release(self, tenant: str) -> None:
        """One of `tenant`'s admitted requests resolved."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None and st[2] > 0:
                st[2] -= 1

    def _evict_idle(self) -> None:
        # caller holds self._lock. Tenants with requests in flight are
        # never evicted (their pending count must survive to release()).
        idle = [k for k, v in self._tenants.items() if v[2] == 0]
        if not idle:
            raise OverloadError(
                f"tenant table full ({self.MAX_TRACKED} tenants in flight)"
            )
        victim = min(idle, key=lambda k: self._tenants[k][1])
        del self._tenants[victim]

    def stats(self) -> dict:
        with self._lock:
            return {
                t: {"pending": v[2], "admitted": v[3], "rejected": v[4]}
                for t, v in self._tenants.items()
            }

    @classmethod
    def from_env(cls) -> "TenantQuota | None":
        """A quota when EULER_TPU_TENANT_QPS is set, else None (no
        per-tenant admission layer at all)."""
        if os.environ.get("EULER_TPU_TENANT_QPS"):
            return cls()
        return None


@dataclass
class _Request:
    ids: object
    n: int
    future: Future
    deadline: float | None  # absolute time.monotonic(), None = no deadline
    tenant: str | None = None
    enqueued: float = field(default_factory=time.monotonic)


class MicroBatcher:
    """max-batch / max-wait-µs coalescing over a bounded request queue.

    runtime: anything with `predict(ids) -> np.ndarray` (row i of the
    output answers id i). One dispatcher thread owns the runtime, so
    stateful flows (rngs) are never raced.
    """

    def __init__(
        self,
        runtime,
        max_batch: int = 128,
        max_wait_us: int = 2000,
        max_queue: int = 256,
        tenant_quota: TenantQuota | None = None,
    ):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self.runtime = runtime
        self.max_batch = int(max_batch)
        self.max_wait_s = max(int(max_wait_us), 0) / 1e6
        self.max_queue = int(max_queue)
        self.tenant_quota = tenant_quota
        self._pending: list[_Request] = []
        self._cond = threading.Condition()
        self._closed = False
        # telemetry — every write AND read happens under self._cond, so a
        # stats() snapshot is internally consistent (a fleet router ranking
        # replicas must never see inflight and queue_depth from different
        # moments)
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.rejected_overload = 0
        self.rejected_deadline = 0
        self.errors = 0
        self.inflight = 0  # admitted, future not yet resolved
        self.ewma_batch_ms = 0.0  # EWMA device-step latency (load signal)
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="micro-batcher"
        )
        self._thread.start()

    # -- client surface --------------------------------------------------

    def submit(self, ids, deadline: float | None = None, tenant=None) -> Future:
        """Enqueue one request; returns a Future of its [n, D] embeddings.

        deadline: absolute time.monotonic() bound, or None. Raises
        OverloadError IMMEDIATELY when the queue is full (admission
        control — the caller never blocks on a saturated server) or when
        `tenant`'s quota is exhausted (typed per tenant, not global)."""
        import numpy as np

        ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty id list")
        req = _Request(
            ids=ids, n=len(ids), future=Future(), deadline=deadline,
            tenant=tenant if tenant is None else str(tenant),
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._pending) >= self.max_queue:
                self.rejected_overload += 1
                raise OverloadError(
                    f"queue full ({self.max_queue} pending)"
                )
            if self.tenant_quota is not None and req.tenant is not None:
                # raises the tenant-named OverloadError; counts as an
                # overload rejection for the global telemetry too
                try:
                    self.tenant_quota.admit(req.tenant)
                except OverloadError:
                    self.rejected_overload += 1
                    raise
            self.requests += 1
            self.inflight += 1
            self._pending.append(req)
            self._cond.notify_all()
        return req.future

    def predict(self, ids, deadline: float | None = None, tenant=None):
        """submit() + wait. Raises DeadlineExceededError / OverloadError /
        whatever the runtime raised."""
        return self.submit(ids, deadline, tenant=tenant).result()

    def stats(self) -> dict:
        with self._cond:
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "rows": self.rows,
                "rejected_overload": self.rejected_overload,
                "rejected_deadline": self.rejected_deadline,
                "errors": self.errors,
                "pending": len(self._pending),
                # load signals: what least-loaded routing ranks by
                "inflight": self.inflight,
                "queue_depth": len(self._pending),
                "ewma_batch_ms": round(self.ewma_batch_ms, 3),
                "max_batch": self.max_batch,
                "max_wait_us": int(self.max_wait_s * 1e6),
                "max_queue": self.max_queue,
            }
        if self.tenant_quota is not None:
            out["tenants"] = self.tenant_quota.stats()
        return out

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5)
        for req in self._drain():
            self._resolve(req, exc=RuntimeError("batcher closed"))

    def _drain(self) -> list:
        with self._cond:
            out, self._pending = self._pending, []
        return out

    def _resolve(self, req: _Request, result=None, exc=None) -> None:
        """Answer one admitted request and return its quota/inflight
        charge — the ONLY way a request leaves the batcher."""
        if exc is not None:
            if not req.future.done():
                req.future.set_exception(exc)
        else:
            req.future.set_result(result)
        with self._cond:
            self.inflight -= 1
        if self.tenant_quota is not None and req.tenant is not None:
            self.tenant_quota.release(req.tenant)

    # -- dispatcher ------------------------------------------------------

    def _take_batch(self) -> list:
        """Block until work, then linger up to max_wait_s (measured from
        the OLDEST pending request) packing arrivals under max_batch."""
        with self._cond:
            while not self._pending and not self._closed:
                self._cond.wait()
            if self._closed:
                return []
            cutoff = self._pending[0].enqueued + self.max_wait_s
            while (
                sum(r.n for r in self._pending) < self.max_batch
                and not self._closed
            ):
                remaining = cutoff - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            taken, total = [], 0
            while self._pending:
                r = self._pending[0]
                if taken and total + r.n > self.max_batch:
                    break  # next dispatch takes it; a single oversized
                    # request still runs alone (runtime chunks it)
                taken.append(self._pending.pop(0))
                total += r.n
            return taken

    def _dispatch_loop(self):
        import numpy as np

        while True:
            taken = self._take_batch()
            if not taken:
                if self._closed:
                    return
                continue
            now = time.monotonic()
            live = []
            for r in taken:
                if r.deadline is not None and now > r.deadline:
                    with self._cond:
                        self.rejected_deadline += 1
                    self._resolve(
                        r,
                        exc=DeadlineExceededError(
                            f"deadline passed {now - r.deadline:.3f}s "
                            "before dispatch"
                        ),
                    )
                else:
                    live.append(r)
            if not live:
                continue
            try:
                t0 = time.perf_counter()
                emb = self.runtime.predict(
                    np.concatenate([r.ids for r in live])
                )
                step_ms = (time.perf_counter() - t0) * 1e3
                with self._cond:
                    self.batches += 1
                    self.rows += sum(r.n for r in live)
                    self.ewma_batch_ms = (
                        step_ms
                        if self.batches == 1
                        else (1.0 - _EWMA_ALPHA) * self.ewma_batch_ms
                        + _EWMA_ALPHA * step_ms
                    )
                off = 0
                for r in live:
                    self._resolve(r, result=emb[off : off + r.n])
                    off += r.n
            except BaseException as e:  # report per-request, keep serving
                with self._cond:
                    self.errors += 1
                for r in live:
                    self._resolve(r, exc=e)
