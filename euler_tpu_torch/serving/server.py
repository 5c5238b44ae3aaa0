"""ModelServer — `predict`/`server_stats`/`reload` wire verbs over the
pooled-TCP stack (counterpart: euler_tpu/serving/server.py).

Reuses the graph service's `_PoolServer` (distributed/service.py): a
selector thread parks idle connections, a bounded worker pool runs the
request cycle. Each worker blocks on its request's future while the
micro-batcher coalesces every in-flight worker's request into one device
step — the pool's concurrency IS the batching window.

Verbs:
  predict      [ids u64[n], deadline_ms float|None, tenant str|None]
                                                    → [emb f32[n, D]]
  server_stats []                                   → [json]
  ping         []                                   → [0]
  reload       [model_dir str|None, canary u64|None]→ [json report]

Overload and deadline rejections ride the existing "err" status frame
with a typed prefix ("OverloadError: ...", "DeadlineExceeded: ...") so
clients raise the typed exception instead of a generic RpcError — and
never failover-retry either (they are deterministic server decisions,
not transport faults). Requests without an explicit predict deadline
inherit the wire-envelope budget every verb now carries.

`reload` is the zero-downtime hot-reload verb: it runs in ONE pool
worker while every other worker keeps serving — the new checkpoint's
programs build and warm off the dispatch path, the engine publish is a
single reference swap, and when the caller ships canary ids the pre/post
rows go through the LIVE batcher (the exact served path) so the returned
`canary_parity` is a bit-level proof, not a side computation.
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np

from euler_tpu_torch.distributed.service import _PoolServer
from euler_tpu_torch.serving.batcher import MicroBatcher, TenantQuota


class ModelServer:
    """Serves one InferenceRuntime over the wire protocol."""

    def __init__(
        self,
        runtime,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int | None = None,
        max_wait_us: int = 2000,
        max_queue: int = 256,
        workers: int | None = None,
        registry=None,
        shard: int = 0,
        tenant_quota: TenantQuota | None = None,
    ):
        self.runtime = runtime
        if max_batch is None:
            max_batch = max(getattr(runtime, "buckets", (128,)))
        if tenant_quota is None:
            tenant_quota = TenantQuota.from_env()
        self.batcher = MicroBatcher(
            runtime,
            max_batch=max_batch,
            max_wait_us=max_wait_us,
            max_queue=max_queue,
            tenant_quota=tenant_quota,
        )
        if workers is None:
            # graph-service sizing (cpu*2) is for CPU-bound store ops; a
            # serving worker spends its life parked on a batcher future
            # while the DEVICE computes, and the number of workers is the
            # coalescing window — size for concurrency, not cores
            import os

            workers = min(64, max(16, (os.cpu_count() or 1) * 4))
        self.server = _PoolServer((host, port), self, workers)
        self.host, self.port = self.server.server_address
        self.registry = registry
        self.shard = shard
        self._beat = None
        self._started = time.monotonic()
        # per-verb wire byte counters, filled by _PoolServer at the
        # socket seam (same telemetry stance as the graph service);
        # surfaced through server_stats -> fleet_stats
        self.wire_bytes_in: collections.Counter = collections.Counter()
        self.wire_bytes_out: collections.Counter = collections.Counter()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        self.server.start()
        if self.registry is not None:
            self._beat = self.registry.register(
                self.shard, self.host, self.port
            )
        return self

    def stop(self, drain_s: float | None = None):
        """Shut down; with drain_s, gracefully: deregister, refuse new
        connections, finish in-flight predicts (bounded), then close."""
        if self._beat is not None:
            self._beat.set()
        if drain_s:
            self.server.drain(drain_s)
        self.server.shutdown()
        self.server.server_close()
        self.batcher.close()

    # -- _PoolServer service surface -------------------------------------

    # Load-bearing: dispatch() gates on it, graftlint's wire-protocol
    # checker diffs it against the `op ==` arms and ServingClient's
    # WIRE_VERBS, and tests/test_wire_parity.py asserts parity at runtime.
    HANDLED_VERBS = frozenset({"predict", "server_stats", "ping", "reload"})

    def dispatch(self, op: str, a: list) -> list:
        if op not in self.HANDLED_VERBS:
            raise ValueError(f"unknown op {op!r}")
        if op == "predict":
            deadline_ms = a[1] if len(a) > 1 else None
            tenant = a[2] if len(a) > 2 else None
            deadline = (
                time.monotonic() + float(deadline_ms) / 1e3
                if deadline_ms
                else None
            )
            if deadline is None:
                # no explicit predict deadline: the wire-envelope budget
                # (every verb carries one now) bounds the batcher wait too
                from euler_tpu_torch.distributed.service import current_deadline

                deadline = current_deadline()
            # admission control raises OverloadError HERE (fast-fail);
            # otherwise the worker blocks on the future while the batcher
            # coalesces it with the other in-flight workers' requests
            return [self.batcher.predict(a[0], deadline, tenant=tenant)]
        if op == "server_stats":
            stats = self.batcher.stats()
            stats.update(
                device_batches=getattr(self.runtime, "device_batches", None),
                buckets=list(getattr(self.runtime, "buckets", ())),
                reloads=getattr(self.runtime, "reloads", 0),
                uptime_s=round(time.monotonic() - self._started, 3),
                wire_bytes_in=dict(self.wire_bytes_in),
                wire_bytes_out=dict(self.wire_bytes_out),
            )
            durability = self._graph_durability()
            if durability is not None:
                stats["graph_shards"] = durability
            return [json.dumps(stats)]
        if op == "ping":
            return [0]
        if op == "reload":
            return [json.dumps(self._reload(a))]
        raise RuntimeError(
            f"op {op!r} is in HANDLED_VERBS but has no dispatch arm"
        )

    def _graph_durability(self) -> dict | None:
        """Per-shard durability lag of the graph this server reads. The
        JAX server polls its remote graph shards' `stats` verb here; the
        port reads its graph in process (no remote shards, ROADMAP queue
        1 item 8), so there is nothing to report."""
        return None

    def _reload(self, a: list) -> dict:
        """Hot-swap the runtime's checkpoint with a canary bit-parity
        proof measured through the live batcher (the served path)."""
        from euler_tpu_torch.distributed.service import current_deadline

        model_dir = a[0] if a else None
        canary = a[1] if len(a) > 1 else None
        deadline = current_deadline()
        pre = None
        if canary is not None and len(canary):
            canary = np.asarray(canary, np.uint64).reshape(-1)
            pre = self.batcher.predict(canary, deadline)
        report = self.runtime.swap(cfg=model_dir if model_dir else None)
        if pre is not None:
            post = self.batcher.predict(canary, deadline)
            report["canary_n"] = int(len(canary))
            report["canary_parity"] = bool(
                pre.shape == post.shape
                and pre.dtype == post.dtype
                and np.array_equal(pre, post)
            )
        return report
