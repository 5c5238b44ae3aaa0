"""Deterministic fault injection for the RPC substrate
(counterpart: euler_tpu/distributed/chaos.py, copied whole).

Failure behavior must be reproducible test input, not folklore: a seeded
`FaultPlan` describes WHICH faults fire WHERE and WHEN, and the client
transport (`_Replica.call`) and server dispatch (`_PoolServer._respond`)
consult it at well-defined points. The same plan + the same call order
replays the same faults, so recovery tests can assert bit-identical
results instead of "it usually survives".

Fault sites and kinds:
  client (before the request leaves the process; matches shard /
  replica address / op):
    reset      — ConnectionResetError, as if the peer RST the socket
    eof        — clean close, as if the server shut down mid-stream
    delay      — fixed (+ per-firing ramp) latency before the call
    blackhole  — the replica never answers: hold, then socket.timeout
  server (inside the worker, around dispatch; matches shard / op):
    delay      — slow handler (fixed + ramp)
    err        — typed err frame (`message`) instead of dispatch
    eof        — close the connection without responding
    reset      — RST the connection (SO_LINGER 0) without responding
    truncate   — send a torn response frame (prefix bytes), then close
    corrupt    — flip bytes inside an otherwise well-framed response
    blackhole  — hold the connection open unanswered, then close

Enable programmatically (`install(FaultPlan(...))`, or pass
`fault_plan=` to a server) or via `EULER_TPU_CHAOS` (JSON spec, picked
up by any process — the bench's spawned shard servers inherit it).
When no plan is installed the hot-path cost is one module-global read.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

# fault kinds valid per site (spec validation: a typo'd kind must fail
# loudly at plan build, not silently never fire)
CLIENT_KINDS = frozenset({"reset", "eof", "delay", "blackhole"})
SERVER_KINDS = frozenset(
    {"delay", "err", "eof", "reset", "truncate", "corrupt", "blackhole"}
)


@dataclass
class Fault:
    """One fault rule: match predicate + firing schedule + action."""

    kind: str
    site: str = "client"  # "client" | "server"
    op: str | None = None  # None = any verb
    shard: int | None = None  # None = any shard
    replica: tuple | None = None  # (host, port); client site only
    after: int = 0  # skip the first `after` matching calls
    count: int | None = None  # fire at most `count` times (None = forever)
    prob: float = 1.0  # seeded coin per eligible call
    delay_s: float = 0.05
    ramp_s: float = 0.0  # delay grows by this much every firing
    hold_s: float = 30.0  # blackhole hold before giving up the socket
    message: str = "RpcError: chaos-injected error"
    # runtime state (owned by the plan's lock)
    matched: int = 0
    fired: int = 0

    def __post_init__(self):
        valid = CLIENT_KINDS if self.site == "client" else SERVER_KINDS
        if self.site not in ("client", "server"):
            raise ValueError(f"bad fault site {self.site!r}")
        if self.kind not in valid:
            raise ValueError(
                f"bad {self.site} fault kind {self.kind!r}"
                f" (valid: {sorted(valid)})"
            )
        if self.replica is not None:
            self.replica = (str(self.replica[0]), int(self.replica[1]))


@dataclass
class FaultDecision:
    """One firing, resolved: what the hook should do."""

    kind: str
    delay_s: float = 0.0
    hold_s: float = 0.0
    message: str = ""


class FaultPlan:
    """Seeded, thread-safe schedule over a list of `Fault` rules.

    Match counters and the probability stream live under one lock, so a
    single-threaded call sequence replays exactly; concurrent callers
    still get a consistent (if interleaving-dependent) schedule.
    """

    def __init__(self, faults, seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    # -- spec I/O --------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str | dict) -> "FaultPlan":
        """Build from the EULER_TPU_CHAOS JSON spec:
        {"seed": 7, "faults": [{"site": "server", "kind": "delay",
         "op": "sample_fanout", "delay_s": 0.05}, ...]}"""
        if isinstance(spec, str):
            spec = json.loads(spec)
        faults = []
        for f in spec.get("faults", []):
            f = dict(f)
            if "replica" in f and f["replica"] is not None:
                f["replica"] = tuple(f["replica"])
            faults.append(Fault(**f))
        return cls(faults, seed=int(spec.get("seed", 0)))

    # -- matching --------------------------------------------------------

    def _decide(self, fault: Fault) -> FaultDecision | None:
        """Firing decision for one matched rule. decisions() holds
        self._lock across every call — the counters never race."""
        idx = fault.matched
        # graftlint: disable=lock-unguarded-write -- caller holds self._lock
        fault.matched += 1
        if idx < fault.after:
            return None
        if fault.count is not None and fault.fired >= fault.count:
            return None
        if fault.prob < 1.0 and float(self._rng.random()) >= fault.prob:
            return None
        n = fault.fired
        # graftlint: disable=lock-unguarded-write -- caller holds self._lock
        fault.fired += 1
        return FaultDecision(
            kind=fault.kind,
            delay_s=fault.delay_s + fault.ramp_s * n,
            hold_s=fault.hold_s,
            message=fault.message,
        )

    def decisions(
        self,
        site: str,
        op: str,
        shard: int | None = None,
        replica: tuple | None = None,
    ) -> list[FaultDecision]:
        out = []
        with self._lock:
            for f in self.faults:
                if f.site != site:
                    continue
                if f.op is not None and f.op != op:
                    continue
                if f.shard is not None and shard is not None and f.shard != shard:
                    continue
                if (
                    f.replica is not None
                    and replica is not None
                    and f.replica != tuple(replica)
                ):
                    continue
                d = self._decide(f)
                if d is not None:
                    out.append(d)
        return out

    def stats(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "site": f.site,
                    "kind": f.kind,
                    "op": f.op,
                    "matched": f.matched,
                    "fired": f.fired,
                }
                for f in self.faults
            ]

    # -- client-side application ----------------------------------------

    def apply_client(
        self,
        shard: int | None,
        replica: tuple,
        op: str,
        timeout_s: float | None,
    ) -> None:
        """Run client-site faults for one attempt; raises the transport
        error the fault models (so the real retry/failover path handles
        it — chaos tests the machinery, it doesn't reimplement it)."""
        import socket as socket_mod

        for d in self.decisions("client", op, shard=shard, replica=replica):
            if d.kind == "delay":
                time.sleep(d.delay_s)
            elif d.kind == "reset":
                raise ConnectionResetError(
                    f"chaos: reset {replica[0]}:{replica[1]} ({op})"
                )
            elif d.kind == "eof":
                raise ConnectionError(
                    f"chaos: peer closed {replica[0]}:{replica[1]} ({op})"
                )
            elif d.kind == "blackhole":
                hold = d.hold_s
                if timeout_s is not None:
                    hold = min(hold, timeout_s)
                time.sleep(hold)
                raise socket_mod.timeout(
                    f"chaos: blackholed {replica[0]}:{replica[1]} ({op})"
                )


# -- process-global plan ----------------------------------------------------

_INSTALL_LOCK = threading.Lock()
_PLAN: FaultPlan | None = None
# env parse cache: (raw spec string, plan) — a changed env var (tests,
# spawned processes) rebuilds; same value reuses counters, which is what
# a long-lived process wants
_ENV_PLAN: tuple[str, FaultPlan] | None = None


def install(plan: FaultPlan | None) -> None:
    """Set (or with None, clear) the process-global fault plan."""
    global _PLAN
    with _INSTALL_LOCK:
        _PLAN = plan


def uninstall() -> None:
    install(None)


def active_plan() -> FaultPlan | None:
    """The installed plan, else one parsed from EULER_TPU_CHAOS, else
    None. The no-chaos fast path is one global read + one env probe."""
    global _ENV_PLAN
    if _PLAN is not None:
        return _PLAN
    spec = os.environ.get("EULER_TPU_CHAOS")
    if not spec:
        return None
    with _INSTALL_LOCK:
        if _ENV_PLAN is None or _ENV_PLAN[0] != spec:
            _ENV_PLAN = (spec, FaultPlan.from_spec(spec))
        return _ENV_PLAN[1]
