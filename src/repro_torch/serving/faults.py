"""Composable fault injection for the serving fabric (chaos harness).

The serving stack instruments a handful of *fault points* — replica
flushes, compaction-daemon ticks, the compact-then-rewire window — and a
:class:`FaultInjector` decides, per point, whether this call fails,
stalls, or blackholes. The chaos suite (``tests/test_torch_chaos.py``) and
``chip_smoke.py``'s serve phase compose rules on one injector and then
assert the service's contract under them: every answer is bit-exact or a
typed error, never a silent truncation and never a hung future. This is
the JAX package's ``repro.serving.faults``, kept as a copy of its own
(pure Python).

Fault classes and where they bite:

  * ``fail_replica(sid, rid)``     — the replica's flush raises
    :class:`InjectedFaultError`: the whole cohort's futures carry it, the
    router sees a typed sub-query failure and retries on a sibling.
  * ``slow_replica(sid, rid, ms)`` — the flush sleeps first: injected
    service latency, the hedging trigger's prey.
  * ``blackhole_replica(sid, rid)``— the flush consumes its cohort and
    answers NOTHING (accepted-then-lost): only hedges or deadlines can
    save those requests — exactly the failure mode they exist for.
  * ``kill_compaction(point=...)`` — the compaction daemon's tick
    (``point="tick"``) or the window between a finished fold and the
    router rewire (``point="swap"``) raises: the daemon must back off and
    survive, and a missed rewire must be reconciled, not double-served.

Crash-restart faults ride the existing durability hooks
(``core.durable.fail_at``), not this injector — a process crash is not an
in-process fault.

Rules are matched most-specific-first; ``times=N`` limits a rule to its
first N firings (then it is spent), ``times=None`` fires forever.
``fired()`` returns per-rule counters so tests can assert a fault
actually bit. All methods are thread-safe — rules are installed and
cleared while daemons run.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Tuple

FAIL, DELAY, BLACKHOLE = "fail", "delay", "blackhole"


class InjectedFaultError(RuntimeError):
    """A fault-injection rule made this call fail (typed, retriable)."""


@dataclasses.dataclass
class _Rule:
    action: str  # FAIL | DELAY | BLACKHOLE
    ms: float = 0.0  # DELAY only
    times: Optional[int] = None  # None = unlimited
    fired: int = 0

    @property
    def live(self) -> bool:
        return self.times is None or self.fired < self.times


class FaultInjector:
    """One shared fault plan, consulted at every instrumented point."""

    def __init__(self):
        self._lock = threading.Lock()
        # replica rules: (sid, rid) exact or (sid, None) = every replica
        self._replica: dict = {}
        self._compaction: dict = {}  # point -> [rules]

    # ------------------------------------------------------------ plan API
    def _add_replica(self, sid: int, rid: Optional[int],
                     rule: _Rule) -> None:
        with self._lock:
            self._replica.setdefault((sid, rid), []).append(rule)

    def fail_replica(self, sid: int, rid: Optional[int] = None,
                     times: Optional[int] = None) -> None:
        """Replica (or whole shard with rid=None) flushes raise."""
        self._add_replica(sid, rid, _Rule(FAIL, times=times))

    def slow_replica(self, sid: int, rid: Optional[int] = None, *,
                     ms: float = 50.0,
                     times: Optional[int] = None) -> None:
        """Replica flushes sleep ``ms`` before answering."""
        self._add_replica(sid, rid, _Rule(DELAY, ms=ms, times=times))

    def blackhole_replica(self, sid: int, rid: Optional[int] = None,
                          times: Optional[int] = None) -> None:
        """Replica flushes consume their cohort and never answer it."""
        self._add_replica(sid, rid, _Rule(BLACKHOLE, times=times))

    def kill_compaction(self, point: str = "tick",
                        times: Optional[int] = 1) -> None:
        """The compaction daemon raises at ``point`` ("tick" | "swap")."""
        with self._lock:
            self._compaction.setdefault(point, []).append(
                _Rule(FAIL, times=times))

    def heal_replica(self, sid: int, rid: Optional[int] = None) -> None:
        """Drop the rules targeting one replica (or the whole shard)."""
        with self._lock:
            if rid is None:
                for key in [k for k in self._replica if k[0] == sid]:
                    del self._replica[key]
            else:
                self._replica.pop((sid, rid), None)

    def clear(self) -> None:
        """Remove every installed fault rule."""
        with self._lock:
            self._replica.clear()
            self._compaction.clear()

    # ---------------------------------------------------- instrumentation
    def _claim(self, rules: List[_Rule]) -> List[Tuple[str, float]]:
        """Mark matching live rules fired; return their actions."""
        out = []
        for r in rules:
            if r.live:
                r.fired += 1
                out.append((r.action, r.ms))
        return out

    def on_flush(self, sid: int, rid: int) -> bool:
        """Replica flush fault point. Returns False to blackhole the
        cohort; may sleep (delay) and/or raise (fail). Delay applies
        before fail so a slow-then-dead replica stalls its caller first —
        the nastiest real-world ordering."""
        with self._lock:
            actions = self._claim(self._replica.get((sid, rid), []))
            actions += self._claim(self._replica.get((sid, None), []))
        for action, ms in actions:
            if action == DELAY and ms > 0:
                time.sleep(ms / 1e3)
        for action, _ in actions:
            if action == FAIL:
                raise InjectedFaultError(
                    f"injected failure at shard {sid} replica {rid}")
        return not any(a == BLACKHOLE for a, _ in actions)

    def on_compaction(self, point: str = "tick") -> None:
        """Compaction fault point; raises to kill this cycle."""
        with self._lock:
            actions = self._claim(self._compaction.get(point, []))
        if any(a == FAIL for a, _ in actions):
            raise InjectedFaultError(
                f"injected compaction kill at point {point!r}")

    # -------------------------------------------------------------- stats
    def fired(self) -> dict:
        """{rule-key: fire count} for every installed rule."""
        with self._lock:
            out = {}
            for (sid, rid), rules in self._replica.items():
                for r in rules:
                    key = f"replica:{sid}:{'*' if rid is None else rid}:" \
                          f"{r.action}"
                    out[key] = out.get(key, 0) + r.fired
            for point, rules in self._compaction.items():
                for r in rules:
                    key = f"compaction:{point}"
                    out[key] = out.get(key, 0) + r.fired
            return out
