"""Typed RPC errors — the failure vocabulary of the distributed layer
(counterpart: euler_tpu/distributed/errors.py, copied whole).

The reference's RPC status codes make every failure machine-dispatchable
(rpc_client.h:32-66 retries transport faults, surfaces server verdicts);
here the same split is a small exception hierarchy that crosses the wire
as an err-frame name prefix ("DeadlineExceeded: ..."):

  RpcError          — deterministic server-side failure. NEVER
                      transport-retried: the server computed this answer,
                      a replica failover would just recompute it.
    DeadlineExceeded — the call's time budget ran out (client-side retry
                      loop, or server-side rejection of already-expired
                      work before dispatch).
    OverloadError    — admission control refused the request (bounded
                      queue full). Retrying amplifies the overload it
                      signals; callers own backoff.

Transport faults (OSError/ConnectionError/timeout/torn frame) are NOT in
this hierarchy on purpose — those are the retryable class.

This module imports nothing so every layer (wire, client, server,
serving, chaos) can depend on it without cycles.
"""

from __future__ import annotations


class RpcError(RuntimeError):
    """Deterministic server-side error — do not failover-retry."""


class DeadlineExceeded(RpcError):
    """The call's time budget expired (client loop or server reject)."""


class OverloadError(RpcError):
    """Admission control refused the request (bounded queue full)."""


class NotPrimaryError(RpcError):
    """A mutation landed on a replica that is not the group's primary
    (follower, or a fenced ex-primary whose lease term went stale).

    The detail carries the group's current coordinates so a writer can
    re-route its keyed outbox without a registry round trip:

        "NotPrimaryError: shard=3 role=follower term=7 primary=host:port"

    `primary=?` when the rejecting replica does not know one (election in
    flight) — the writer falls back to observing the lease."""

    @staticmethod
    def format(shard: int, role: str, term: int, primary) -> str:
        addr = f"{primary[0]}:{primary[1]}" if primary else "?"
        return f"shard={shard} role={role} term={term} primary={addr}"

    @staticmethod
    def parse_primary(message: str):
        """(host, port) named in a NotPrimaryError detail, else None."""
        for tok in message.split():
            if tok.startswith("primary="):
                addr = tok[len("primary="):]
                if addr == "?" or ":" not in addr:
                    return None
                host, _, port = addr.rpartition(":")
                try:
                    return host, int(port)
                except ValueError:
                    return None
        return None


class ReshardFencedError(NotPrimaryError):
    """A mutation landed on a source shard fenced for a reshard cutover.

    Subclasses NotPrimaryError so writers that predate resharding treat
    it with the redirect machinery they already have: the detail carries
    `primary=?`, which makes them drop their primary pin, back off, and
    re-discover — by which time `connect()`'s topology watch has re-routed
    them to the new shard set. The fencing window is bounded by the
    cutover (a few lease TTLs), so the bounded redirect loop rides it out.

        "ReshardFencedError: shard=1 role=fenced term=7 primary=?"
    """


# the serving layer's older name; same class, so except-clauses written against
# either name keep working and the wire prefix stays one canonical string
DeadlineExceededError = DeadlineExceeded

# err-frame name prefix -> exception class. "DeadlineExceededError" stays
# for frames from older servers whose batcher raised under the old name.
WIRE_ERRORS = {
    "RpcError": RpcError,
    "DeadlineExceeded": DeadlineExceeded,
    "DeadlineExceededError": DeadlineExceeded,
    "OverloadError": OverloadError,
    "NotPrimaryError": NotPrimaryError,
    "ReshardFencedError": ReshardFencedError,
}


def from_wire(message: str) -> RpcError:
    """Typed exception for an err-frame payload.

    Server frames carry "<TypeName>: <detail>"; unknown names degrade to
    plain RpcError so new server-side error types never crash old
    clients — they just lose retry-exemption specificity (all RpcErrors
    are exempt anyway)."""
    name = message.split(":", 1)[0].strip()
    cls = WIRE_ERRORS.get(name, RpcError)
    return cls(message)
