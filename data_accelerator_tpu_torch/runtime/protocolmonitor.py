"""Protocol monitor — the DYNAMIC half of the DX9xx exactly-once
story (``analysis/protocheck.py`` is the static half; both check the
SAME rule table, ``analysis/protospec.py``).

The static pass proves the SOURCE orders the delivery protocol
correctly (sink emit -> pointer flip -> FIFO ack -> offset commit,
requeue on failure). This monitor proves each LIVE batch did: the
host's batch tail records every protocol event it performs —
``SINK_EMIT`` after dispatcher fan-out, ``POINTER_FLIP`` after
``processor.commit()``, one ``FIFO_ACK`` per source, the post-commit
``DURABLE_WRITE``/``STATE_PUSH``/``OFFSET_COMMIT`` checkpoint trio,
``REQUEUE`` on the failure path — and at the end of the tail the
sequence is SEALED and its linearization validated with
``protospec.check_sequence`` against the runtime rules (DX900
durability-before-ack, DX901 sink-before-pointer-commit, DX902
ack-at-most-once-per-batch).

Every violated rule becomes ONE runtime **DX906** event per batch —
drained by the host into the flight recorder beside sanitizer poison
hits — and bumps ``Protocol_Violation_Count``; every recorded event
bumps ``Protocol_Events_Count``. A bounded ring of recent sealed
linearizations is kept for post-mortem inspection
(``recent_sequences``). The rescale handoff (DX905) is static-only:
it is a call-order property of the control plane's config build, not
of a batch's event list — the chaos rescale drill covers it end to
end at the batch level instead.

Armed via conf ``datax.job.process.debug.protocolmonitor`` (a debug
mode: the cost is a few appends + one list scan per batch).

Copy of the JAX package's ``runtime/protocolmonitor.py``, whole; the
port's host records the same events at the same points of its batch
tail. The static half is ``analysis/protocheck.py``; the chaos drills
of ``serve/scenarios.py`` arm the monitor.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from ..analysis.protospec import check_sequence

# sealed linearizations kept for post-mortem (per monitor instance)
HISTORY = 64


class ProtocolMonitor:
    """Record per-batch protocol events; validate each sealed batch.

    Thread-safe: the batch tail runs on the landing worker (or inline)
    while the host drains events/metrics at collect time.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events_recorded = 0   # lifetime protocol events
        self.batches_sealed = 0    # lifetime sealed linearizations
        self.violations = 0        # lifetime DX906s fired
        self._batch: List[Dict[str, object]] = []
        self._history: Deque[Dict[str, object]] = deque(maxlen=HISTORY)
        self._events: List[Dict[str, object]] = []
        self._events_drained = 0
        self._violations_drained = 0

    # -- the recording half (batch-tail hooks) ----------------------------
    def record(self, kind: str, source: str = "",
               detail: str = "") -> None:
        """One protocol event performed by the current batch."""
        with self._lock:
            self.events_recorded += 1
            self._batch.append({
                "kind": kind,
                "source": str(source),
                "detail": str(detail),
            })

    def seal_batch(
        self, batch_time_ms: Optional[float] = None,
        failed: bool = False,
    ) -> int:
        """Close the current batch's sequence and validate its
        linearization against the runtime rules. Returns the number of
        NEW violations (at most one per rule per batch)."""
        with self._lock:
            seq, self._batch = self._batch, []
        if not seq:
            return 0
        found = check_sequence(seq, failed=failed)
        with self._lock:
            self.batches_sealed += 1
            self._history.append({
                "batchTime": batch_time_ms,
                "failed": failed,
                "sequence": seq,
                "violations": [c for c, _ in found],
            })
            for code, msg in found:
                self.violations += 1
                self._events.append({
                    "code": "DX906",
                    "rule": code,
                    "failed": failed,
                    "batchTime": batch_time_ms,
                    "sequence": [str(e.get("kind")) for e in seq],
                    "message": (
                        f"DX906: delivery-protocol violation ({code}) "
                        f"— {msg}"
                    ),
                })
        return len(found)

    def recent_sequences(self) -> List[Dict[str, object]]:
        """The last ``HISTORY`` sealed linearizations (post-mortem)."""
        with self._lock:
            return list(self._history)

    # -- event/metric drains (host collect cadence) -----------------------
    def drain_events(self) -> List[Dict[str, object]]:
        """DX906 events since the last drain (flight-recorder feed)."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def drain_metric_deltas(self) -> Dict[str, float]:
        """Protocol_* metric deltas since the last drain; the violation
        count is only reported once nonzero (silence == health, like
        the sanitizer's poison-hit counter)."""
        with self._lock:
            ev = self.events_recorded - self._events_drained
            self._events_drained = self.events_recorded
            v = self.violations - self._violations_drained
            self._violations_drained = self.violations
        out: Dict[str, float] = {}
        if ev:
            out["Protocol_Events_Count"] = float(ev)
        if v:
            out["Protocol_Violation_Count"] = float(v)
        return out


def from_conf(dbg_conf) -> Optional[ProtocolMonitor]:
    """``datax.job.process.debug.protocolmonitor=true`` arms the
    monitor (``dbg_conf`` is the ``debug.`` sub-dictionary)."""
    # dx-conf: read debug.protocolmonitor default=false
    flag = (dbg_conf.get_or_else("protocolmonitor", "false") or "").lower()
    return ProtocolMonitor() if flag == "true" else None
