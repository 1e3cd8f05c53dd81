"""In-process metric store: sorted sets of (timestamp, payload) per key.

Plays the role Redis plays for the reference (metrics written with
``zadd app:metric {uts,val}`` — MetricLogger.scala:20-24 and
IngestorEventProcessor.cs:92-96,141 — and read back by the dashboard via
``zrangebyscore`` — redisProxy.js:21-52). The API mirrors the sorted-set
subset used so a real Redis can be swapped in behind the same calls.

Copy of the JAX package's ``obs/store.py``, less an unused import. The
port keeps its own process-wide ``METRIC_STORE``.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, List, Tuple


class MetricStore:
    def __init__(self):
        self._lock = threading.Lock()
        # key -> sorted list of (score, member)
        self._sets: Dict[str, List[Tuple[float, str]]] = {}
        self._listeners: List = []

    # -- redis-like sorted set ops --------------------------------------
    def zadd(self, key: str, score: float, member: str) -> None:
        with self._lock:
            entries = self._sets.setdefault(key, [])
            bisect.insort(entries, (score, member))
        for fn in list(self._listeners):
            try:
                fn(key, score, member)
            except Exception:
                pass

    def zrangebyscore(
        self, key: str, lo: float, hi: float
    ) -> List[Tuple[float, str]]:
        with self._lock:
            entries = self._sets.get(key, [])
            i = bisect.bisect_left(entries, (lo, ""))
            j = bisect.bisect_right(entries, (hi, "￿"))
            return entries[i:j]

    def zcard(self, key: str) -> int:
        with self._lock:
            return len(self._sets.get(key, []))

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._sets if k.startswith(prefix)]

    def clear(self) -> None:
        with self._lock:
            self._sets.clear()

    # -- push feed (socket.io analog for the dashboard) ------------------
    def subscribe(self, fn) -> None:
        """fn(key, score, member) called on every zadd (dashboard push —
        the analog of redisProxy.js polling + socket.io 'datapoints')."""
        self._listeners.append(fn)

    def unsubscribe(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    # -- convenience -----------------------------------------------------
    def add_point(self, key: str, uts_ms: int, value) -> None:
        self.zadd(key, float(uts_ms), json.dumps({"uts": uts_ms, "val": value}))

    def points(self, key: str, lo_ms: float = 0, hi_ms: float = float("inf")):
        return [json.loads(m) for _, m in self.zrangebyscore(key, lo_ms, hi_ms)]


# the one-box process-wide store (DeploymentLocal's Redis analog)
METRIC_STORE = MetricStore()
