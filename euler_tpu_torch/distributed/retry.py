"""Retry discipline: deadlines, exponential backoff, retry budgets
(counterpart: euler_tpu/distributed/retry.py, copied whole).

The reference pairs its 10x retry loop with bad-host quarantine and timed
revival (rpc_manager.h:66-124, rpc_client.h:32-66); this module supplies
the discipline AROUND that loop that the reference gets from gRPC:

  RetryPolicy — per-call deadline (EULER_TPU_RPC_TIMEOUT_S replaces the
                old hardcoded 30 s socket timeout), per-attempt socket
                timeout, exponential backoff with DETERMINISTIC seeded
                jitter (same seed -> same schedule, so failure tests
                replay bit-identically), attempt cap.
  RetryBudget — per-shard token bucket that stops retry storms: each
                transport retry spends a token, each success refills a
                fraction; when the bucket is dry the call fails fast
                instead of joining a thundering herd against a shard
                that is already down.

Everything here is pure policy — no sockets — so it is unit-testable
without a cluster and shared by the graph and serving clients.
"""

from __future__ import annotations

import itertools
import os
import threading
from dataclasses import dataclass

import numpy as np

# Replaces the hardcoded 30 s socket timeout: the default budget for one
# logical call INCLUDING retries and backoff. Also the connect timeout.
DEFAULT_TIMEOUT_S = 30.0


def default_timeout_s() -> float:
    """The configured per-call deadline (EULER_TPU_RPC_TIMEOUT_S)."""
    return float(os.environ.get("EULER_TPU_RPC_TIMEOUT_S", DEFAULT_TIMEOUT_S))


@dataclass
class RetryPolicy:
    """Backoff + deadline policy for one client (shard handle).

    retries=0 means "defer to the caller's attempt cap" (RemoteShard keeps
    its RETRIES class attribute so existing tests/tuning keep working).
    """

    retries: int = 0
    timeout_s: float | None = None  # None -> default_timeout_s() per call
    attempt_timeout_s: float = 10.0
    backoff_base_s: float = 0.02
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0
    jitter: float = 0.5  # fraction of each backoff that is randomized
    seed: int = 0

    def __post_init__(self):
        # per-call jitter streams: SeedSequence([seed, call#]) — drawing
        # never touches shared Generator state, so concurrent calls stay
        # deterministic given their call index
        self._call_ids = itertools.count()

    @classmethod
    def from_env(cls, seed: int = 0) -> "RetryPolicy":
        e = os.environ.get
        return cls(
            retries=int(e("EULER_TPU_RPC_RETRIES", 0)),
            attempt_timeout_s=float(e("EULER_TPU_RPC_ATTEMPT_TIMEOUT_S", 10.0)),
            backoff_base_s=float(e("EULER_TPU_RPC_BACKOFF_S", 0.02)),
            seed=seed,
        )

    def deadline_budget_s(self, deadline_s: float | None) -> float:
        if deadline_s is not None:
            return float(deadline_s)
        if self.timeout_s is not None:
            return float(self.timeout_s)
        return default_timeout_s()

    def call_rng(self) -> np.random.Generator:
        """A fresh deterministic jitter stream for one logical call."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, next(self._call_ids)])
        )

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        """Sleep before retry `attempt` (attempt 0 = first retry)."""
        base = min(
            self.backoff_max_s,
            self.backoff_base_s * self.backoff_mult**attempt,
        )
        if self.jitter <= 0:
            return base
        u = float(rng.random())
        return base * (1.0 - self.jitter + self.jitter * u)


class RetryBudget:
    """Token bucket bounding transport retries per shard.

    gRPC retry-throttling semantics: spend 1 token per retry, refill
    `refill` per successful call, never above `cap`. A dry bucket means
    the shard is systematically failing — more retries would only add
    load exactly when the shard can least absorb it, so fail fast and
    let quarantine + timed revival do their job.
    """

    def __init__(self, cap: float = 16.0, refill: float = 0.5):
        self.cap = float(cap)
        self.refill = float(refill)
        self._lock = threading.Lock()
        self._tokens = float(cap)
        self._denied = 0

    @property
    def tokens(self) -> float:
        return self._tokens

    @property
    def denied(self) -> int:
        """Spends refused by a dry bucket — the storms that did NOT
        happen (retry storms for the RPC retry loop, hedge storms for
        the serving router); dashboards watch this to see a budget
        actively protecting a degraded fleet."""
        return self._denied

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self._denied += 1
            return False

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.refill)
