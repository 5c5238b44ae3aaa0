"""ServingClient — predict() against a ModelServer fleet, with retries
(counterpart: euler_tpu/serving/client.py, copied whole).

Transport is the graph client's replica pool (distributed/client.py
RemoteShard): round-robin replicas with bad-host quarantine + timed
revival, bounded retries for TRANSPORT faults only. Server-side
decisions come back as "err" frames and are re-raised typed without
retry: OverloadError and DeadlineExceededError are deterministic
admission/deadline verdicts — retrying them at the transport layer would
amplify exactly the overload they signal. Callers own backoff policy.

With `routing=` configured, predict() goes through a ServingRouter
instead of the round-robin pool: consistent-hash or least-loaded replica
choice, transport failover, and (optional) budget-capped hedging — see
serving/router.py. `fleet_stats()` / `ping_all()` address every replica
individually either way, so operators see the whole fleet, not whichever
replica the pool rotated onto.
"""

from __future__ import annotations

import json

import numpy as np

from euler_tpu_torch.distributed.client import RemoteShard, _Replica
from euler_tpu_torch.distributed.errors import RpcError  # noqa: F401 (re-export)
from euler_tpu_torch.serving.batcher import (  # noqa: F401 (re-exports)
    DeadlineExceededError,
    OverloadError,
)


class ServingClient:
    """Client for one model served by N replicas."""

    # Load-bearing verb table — graftlint's wire-protocol checker diffs
    # it against the verbs this module (and the router) actually sends
    # and against ModelServer.HANDLED_VERBS; tests/test_wire_parity.py
    # does the same with the real classes at runtime.
    WIRE_VERBS = frozenset({"predict", "server_stats", "ping", "reload"})

    def __init__(
        self,
        replicas,
        deadline_ms: float | None = None,
        routing=None,
        hedge_ms: float | None = None,
        tenant: str | None = None,
    ):
        """replicas: (host, port) or [(host, port), ...].
        deadline_ms: default per-request deadline shipped to the server
        (None = requests wait as long as the transport allows).
        routing: None (the round-robin pool), a policy name
        ("consistent_hash" / "least_loaded"), or a ServingRouter to
        route predict() through. hedge_ms pins the router's hedge delay
        (None = p95-tracked). tenant: default tenant every predict is
        accounted to (per-tenant admission quotas)."""
        if isinstance(replicas, tuple) and len(replicas) == 2 and isinstance(
            replicas[0], str
        ):
            replicas = [replicas]
        self.replicas = [(str(h), int(p)) for h, p in replicas]
        self._pool = RemoteShard(0, self.replicas)
        self.deadline_ms = deadline_ms
        self.tenant = tenant
        self._router = None
        if routing is not None:
            from euler_tpu_torch.serving.router import ServingRouter

            self._router = (
                routing
                if isinstance(routing, ServingRouter)
                else ServingRouter(
                    self.replicas,
                    policy=routing,
                    deadline_ms=deadline_ms,
                    hedge_ms=hedge_ms,
                )
            )
        # per-address handles for the fleet operator surface (stats/ping
        # must reach EVERY replica, not whichever the pool rotates onto)
        self._fleet = [
            _Replica(h, p, shard=i) for i, (h, p) in enumerate(self.replicas)
        ]

    @property
    def rpc_count(self) -> int:
        n = self._pool.rpc_count
        if self._router is not None:
            n += self._router.rpc_count
        return n

    @property
    def router(self):
        """The configured ServingRouter (None in round-robin mode)."""
        return self._router

    def _call(self, op: str, values: list) -> list:
        # err frames already come back typed (errors.from_wire in the
        # transport): OverloadError / DeadlineExceeded are RpcError
        # subclasses, raised as themselves and never transport-retried
        return self._pool.call(op, values)

    # -- surface ---------------------------------------------------------

    def predict(
        self,
        node_ids,
        deadline_ms: float | None = None,
        tenant: str | None = None,
    ) -> np.ndarray:
        """Embeddings for node_ids ([n, D]); raises OverloadError /
        DeadlineExceededError on fast-fail verdicts. Routed through the
        ServingRouter when one is configured."""
        ids = np.asarray(node_ids, dtype=np.uint64).reshape(-1)
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        tn = tenant if tenant is not None else self.tenant
        if self._router is not None:
            return self._router.predict(ids, deadline_ms=dl, tenant=tn)
        return self._call(
            "predict", [ids, float(dl) if dl is not None else None, tn]
        )[0]

    def stats(self) -> dict:
        """server_stats from ONE replica (whichever the pool rotates
        onto) — fleet_stats() for the whole fleet. The reply carries the
        server's per-verb wire_bytes_in/out; this handle's own counters
        ride along under client_wire_bytes_*."""
        out = json.loads(self._call("server_stats", [])[0])
        out["client_wire_bytes_out"] = dict(self._pool.wire_bytes_out)
        out["client_wire_bytes_in"] = dict(self._pool.wire_bytes_in)
        return out

    def fleet_stats(self, timeout_s: float = 2.0) -> dict:
        """server_stats from EVERY replica, keyed "host:port";
        unreachable replicas map to {"error": ...} instead of vanishing
        from the operator's view."""
        out = {}
        for r in self._fleet:
            try:
                out[f"{r.host}:{r.port}"] = json.loads(
                    r.call("server_stats", [], timeout_s=timeout_s)[0]
                )
            except Exception as e:
                r.drop()
                out[f"{r.host}:{r.port}"] = {"error": repr(e)[:200]}
        return out

    def ping(self) -> bool:
        return self._call("ping", []) == [0]

    def ping_all(self, timeout_s: float = 2.0) -> dict:
        """Per-replica liveness, keyed "host:port" — a dead replica is
        False here while ping() may happily answer from a survivor."""
        out = {}
        for r in self._fleet:
            try:
                out[f"{r.host}:{r.port}"] = (
                    r.call("ping", [], timeout_s=timeout_s) == [0]
                )
            except Exception:
                r.drop()
                out[f"{r.host}:{r.port}"] = False
        return out

    def reload(
        self,
        model_dir: str | None = None,
        canary_ids=None,
        timeout_s: float = 120.0,
    ) -> dict:
        """Rolling zero-downtime hot reload across the fleet: each
        replica swaps to the checkpoint under `model_dir` (None =
        re-restore its current model_dir, picking up a newer checkpoint
        saved in place) while the others keep serving. Returns per-
        replica reports keyed "host:port"; with canary_ids each report
        carries `canary_parity` — pre/post-swap rows measured through
        that replica's LIVE batcher."""
        canary = (
            np.asarray(canary_ids, np.uint64).reshape(-1)
            if canary_ids is not None
            else None
        )
        out = {}
        for r in self._fleet:
            try:
                out[f"{r.host}:{r.port}"] = json.loads(
                    r.call(
                        "reload",
                        [model_dir, canary],
                        timeout_s=timeout_s,
                        budget_ms=timeout_s * 1e3,
                    )[0]
                )
            except Exception as e:
                r.drop()
                out[f"{r.host}:{r.port}"] = {"error": repr(e)[:200]}
        return out

    def close(self):
        if self._router is not None:
            self._router.close()
        for r in self._pool.replicas:
            r.drop()
        for r in self._fleet:
            r.drop()
        self._pool.close()
