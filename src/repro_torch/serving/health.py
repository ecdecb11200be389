"""Per-replica health tracking + placement for replica shard groups.

Every shard in the fault-tolerant router is served by R interchangeable
replicas (same immutable index, own batcher + daemon thread). This module
is the router's view of how each replica is doing and where the next
sub-query should go:

  * :class:`ReplicaHealth` — EWMA answer latency, success/failure
    counters, and a consecutive-failure breaker: ``down_after`` failures
    in a row mark the replica down, after which ``healthy()`` goes False
    and placement routes around it. A down replica is not down forever —
    once ``probe_after_ms`` has elapsed, ``healthy()`` lets ONE request
    through (half-open probing, classic circuit-breaker shape); a success
    closes the breaker, a failure re-opens it for another probe window.
  * :func:`choose_replica` — least-queue-depth placement with
    power-of-two-choices sampling: among the healthy candidates, two are
    sampled at random and the one with the shorter pending queue wins
    (with <= 2 candidates this degenerates to plain least-queue-depth).
    P2C gives near-least-loaded balancing without every submit scanning
    every replica, and the randomness keeps a herd of submitters from
    synchronizing on the same "least loaded" victim. When NO candidate is
    healthy the least-loaded unhealthy one is returned instead — a dying
    fleet degrades to best-effort rather than refusing outright (the
    typed-failure path still surfaces whatever that replica does).

Latency is recorded from submit to future resolution (queue wait
included): that is the quantity hedging reasons about, not bare engine
time.

This is the JAX package's ``repro.serving.health``, kept as a copy of its
own (pure Python): the same seeded ``rng`` makes the same choices in both.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional, Sequence


class ReplicaHealth:
    """Thread-safe EWMA latency + circuit-breaker state for one replica.

    Parameters
    ----------
    ewma_alpha:     weight of the newest latency sample (0 < alpha <= 1).
    down_after:     consecutive failures that open the breaker.
    probe_after_ms: how long an open breaker waits before letting one
                    probe request through (half-open).
    """

    def __init__(
        self,
        *,
        ewma_alpha: float = 0.2,
        down_after: int = 3,
        probe_after_ms: float = 250.0,
    ):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if down_after < 1:
            raise ValueError("down_after must be >= 1")
        self.ewma_alpha = ewma_alpha
        self.down_after = down_after
        self.probe_after_ms = probe_after_ms
        self._lock = threading.Lock()
        self._ewma_ms: Optional[float] = None
        self._successes = 0
        self._failures = 0
        self._streak = 0
        self._down_since: Optional[float] = None
        self._probed_at: Optional[float] = None

    # ----------------------------------------------------------- recording
    def record_success(self, latency_ms: float) -> None:
        """One answered sub-query: closes the breaker, updates the EWMA."""
        with self._lock:
            self._successes += 1
            self._streak = 0
            self._down_since = None
            self._probed_at = None
            if self._ewma_ms is None:
                self._ewma_ms = float(latency_ms)
            else:
                a = self.ewma_alpha
                self._ewma_ms = a * float(latency_ms) + (1 - a) * self._ewma_ms

    def record_failure(self) -> None:
        """One failed sub-query (engine error / injected fault)."""
        with self._lock:
            self._failures += 1
            self._streak += 1
            if self._streak >= self.down_after and self._down_since is None:
                self._down_since = time.monotonic()
            # A failure while half-open re-opens the breaker: the next
            # probe waits a fresh probe_after_ms from NOW.
            if self._down_since is not None:
                self._down_since = time.monotonic()
                self._probed_at = None

    # ------------------------------------------------------------- queries
    def healthy(self, now: Optional[float] = None) -> bool:
        """Should placement consider this replica? Half-open lets ONE
        request probe a down replica per probe window."""
        with self._lock:
            if self._down_since is None:
                return True
            now = time.monotonic() if now is None else now
            if (now - self._down_since) * 1e3 < self.probe_after_ms:
                return False
            if self._probed_at is None:
                self._probed_at = now  # this caller is the probe
                return True
            return False

    @property
    def down(self) -> bool:
        """Whether the breaker currently holds this replica out of placement."""
        with self._lock:
            return self._down_since is not None

    @property
    def ewma_ms(self) -> Optional[float]:
        """EWMA answer latency (None before the first success)."""
        with self._lock:
            return self._ewma_ms

    def snapshot(self) -> dict:
        """Point-in-time dict of the health state (for ``stats()``)."""
        with self._lock:
            return dict(
                ewma_ms=self._ewma_ms,
                successes=self._successes,
                failures=self._failures,
                failure_streak=self._streak,
                down=self._down_since is not None,
            )


def choose_replica(
    replicas: Sequence,
    *,
    exclude: Sequence[int] = (),
    rng: Optional[random.Random] = None,
):
    """Pick the replica the next sub-query should ride (or None).

    ``replicas`` are objects exposing ``rid``, ``health`` (a
    :class:`ReplicaHealth`) and ``queue_depth()`` — the router's
    ``_Replica`` entries. ``exclude`` removes rids already tried by this
    request (a retry or hedge must land on a *sibling*). Healthy
    candidates win; among 3+ of them two are sampled (power-of-two
    choices) and the shorter queue wins; with none healthy the
    least-loaded remaining candidate is returned, and with everything
    excluded the answer is None (the caller gives up on this shard).
    """
    excluded = set(exclude)
    pool = [r for r in replicas if r.rid not in excluded]
    if not pool:
        return None
    healthy = [r for r in pool if r.health.healthy()]
    candidates = healthy or pool
    if len(candidates) > 2:
        candidates = (rng or random).sample(candidates, 2)
    return min(candidates, key=lambda r: r.queue_depth())
