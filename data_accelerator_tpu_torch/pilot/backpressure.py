"""Source backpressure: the token bucket the ingestor consults.

reference: the reference platform throttles EventHub ingest with a
STATIC ``maxRate`` chosen at deploy time (EventHubStreamingFactory
.scala:43) and leans on operators to retune it when sinks fall behind
(SURVEY §1 "babysitting"); production stream processors instead carry
a dynamic admission limiter between source and pipeline (Spark's PID
RateEstimator, Kafka quota buckets — PAPERS.md). This module is that
limiter for the TPU runtime: a token bucket whose *refill rate* is the
pilot's actuation surface.

Mechanics: the bucket holds up to ``capacity`` event-tokens and refills
at ``rate`` tokens/second. While the rate sits at base the admission
point (``PilotController.admit_events``) passes polls through without
consulting the bucket — an unpaced loop must never be starved by its
own cadence; when the pilot ``throttle()``s, the refill rate halves
(floored at ``min_fraction`` of the base rate), stored tokens clamp
down with it, and every poll asks ``take(n)`` and receives
``min(n, floor(tokens))`` — polls shrink until the landing backlog
drains, at which point ``recover()`` doubles the rate back toward
base and admission goes pass-through again. The host's existing multiplicative
``_rate_scale`` loop keeps handling *interval overruns*; this bucket
handles *downstream pressure* (sink/landing lag), which overruns never
see because the landing thread hides them from the dispatch loop.

All methods are safe to call from the dispatch loop and the pilot's
evaluation concurrently (one lock, no blocking waits — a poll that
finds an empty bucket gets the floor grant, never sleeps).

Copy of the JAX package's ``pilot/backpressure.py``, unchanged.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Event-admission token bucket with a pilot-adjustable refill rate.

    ``base_rate``: tokens/second at full health (normally the source's
    configured maxrate). ``capacity``: burst bound (defaults to two
    base-rate seconds so a paced poll is never starved at full rate).
    ``min_fraction``: the throttle floor — matches the host rate
    limiter's 1/8 floor so backpressure can squeeze polls hard without
    ever stopping the flow (a stopped flow can't observe recovery).
    """

    def __init__(
        self,
        base_rate: float,
        capacity: float | None = None,
        min_fraction: float = 0.125,
        now_fn=time.monotonic,
    ):
        if base_rate <= 0:
            raise ValueError(f"base_rate must be > 0, got {base_rate}")
        self.base_rate = float(base_rate)
        self.capacity = float(
            capacity if capacity is not None else 2.0 * base_rate
        )
        self.min_fraction = float(min_fraction)
        self.rate = self.base_rate
        self.now = now_fn
        self._tokens = self.capacity
        self._last_refill = self.now()
        self._lock = threading.Lock()

    # -- internals --------------------------------------------------------
    def _refill_locked(self) -> None:
        now = self.now()
        dt = max(0.0, now - self._last_refill)
        self._last_refill = now
        self._tokens = min(self.capacity, self._tokens + dt * self.rate)

    # -- the ingestor's side ----------------------------------------------
    def take(self, n: int) -> int:
        """Grant up to ``n`` event-tokens (at least 1 — the flow must
        keep moving to observe the drain that ends the throttle)."""
        if n <= 0:
            return 0
        with self._lock:
            self._refill_locked()
            grant = int(min(float(n), self._tokens))
            grant = max(1, grant)
            self._tokens = max(0.0, self._tokens - grant)
            return grant

    # -- the pilot's side -------------------------------------------------
    def throttle(self, factor: float = 0.5) -> float:
        """Shrink the refill rate (and clamp stored tokens down so the
        squeeze takes effect on the very next poll, not a burst later);
        returns the new rate."""
        with self._lock:
            self._refill_locked()
            floor = self.base_rate * self.min_fraction
            self.rate = max(floor, self.rate * factor)
            self._tokens = min(self._tokens, self.rate)
            return self.rate

    def recover(self, factor: float = 2.0) -> float:
        """Grow the refill rate back toward base; returns the new rate."""
        with self._lock:
            self._refill_locked()
            self.rate = min(self.base_rate, self.rate * factor)
            return self.rate

    # -- observability ----------------------------------------------------
    def tokens(self) -> float:
        """Current token balance (the ``Pilot_Backpressure_Tokens``
        gauge)."""
        with self._lock:
            self._refill_locked()
            return self._tokens

    def rate_fraction(self) -> float:
        """Refill rate as a fraction of base — 1.0 means no
        backpressure engaged."""
        with self._lock:
            return self.rate / self.base_rate

    @property
    def engaged(self) -> bool:
        with self._lock:
            return self.rate < self.base_rate
