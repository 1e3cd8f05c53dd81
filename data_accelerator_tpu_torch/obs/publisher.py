"""Per-replica telemetry frame publisher: the push half of the fleet
telemetry plane (the pull/merge half is obs/fleetview.py).

Every replica host accumulates its per-batch observability surfaces —
metric-counter deltas, last gauge values, the per-stage
``LatencyHistogram`` states, firing alerts, health, watermark/offset
progress, and per-source-offset-range ingested/emitted event counts —
into a compact windowed **telemetry frame** and publishes it to the
shared object store, keyed flow x replica x window::

    <prefix>/fleet/<flow>/<replica>/<window:08d>.json

Monarch-style push-based collection: the control plane never scrapes N
replica ``/metrics`` endpoints; each replica ships its own windowed
delta and the ``FleetView`` merges frames into fleet-level series
(counters summed, fixed-bucket histograms merged exactly).

Posture is **fail-open**: telemetry must never take down a batch. A
failed publish is counted (``Fleet_FramePublishError_Count``) and the
window's accumulators are RETAINED — the next successful frame carries
the missed window's deltas too, so counter conservation (the DX54x
delivery audit's input) survives transient store outages. Contrast the
state snapshot mirror (runtime/statepartition.py), which fails CLOSED:
dropped state is data loss, dropped telemetry is a gap on a dashboard.

The host calls ``record_batch`` from ``_finish_tail`` — which under
background transfer runs on the landing thread — so everything here is
lock-guarded. ``flush(final=True)`` (from ``StreamingHost.stop``) ships
the tail window marked ``"final": true``: the fleet view reads that
marker as a clean drain, distinguishing a completed replica from one
that died mid-stream (the DX542 stale-replica signal). ``kill()`` is
the chaos hook that suppresses exactly that final frame — simulating a
replica lost without drain (serve/scenarios.py rescale drill).

Frame schema is documented in OBSERVABILITY.md "Fleet telemetry
plane"; FRAME_VERSION gates forward-compat decoding.

Copy of the JAX package's ``obs/publisher.py``, whole: a port host and a
JAX host publish the same frames for the same batches, so one
``FleetView`` merges replicas of either package. The chaos drills of
``serve/scenarios.py`` call ``kill()``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional

from ..constants import MetricName
from ..core.config import SettingNamespace
from .histogram import HISTOGRAMS, HistogramRegistry

logger = logging.getLogger(__name__)

FRAME_VERSION = 1

# metric-name suffixes treated as window-summable counters; everything
# else in the per-batch metric dict is a gauge (last value wins). The
# per-batch *_Count/*_Events_Count/*_Bytes values are already deltas
# ("events this batch"), so summing them over the window yields the
# windowed delta the fleet rollup sums again across replicas.
_COUNTER_SUFFIXES = (
    "_Count", "_Bytes", "_GroupsDropped", "_JoinRowsDropped",
)


def is_counter_metric(name: str) -> bool:
    return name.endswith(_COUNTER_SUFFIXES)


class TelemetryFramePublisher:
    """Accumulates one replica's per-batch telemetry into windowed
    frames and publishes them to the shared object store."""

    def __init__(
        self,
        url: str,
        flow: str,
        replica: str = "r1",
        replica_index: int = 1,
        replica_count: int = 1,
        window_s: float = 10.0,
        metric_logger=None,
        histograms: Optional[HistogramRegistry] = None,
        token: Optional[str] = None,
        client=None,
        now_fn=time.time,
    ):
        from ..compile.aotcache import _parse_objstore_url
        from ..serve.objectstore import ObjectStoreClient

        if client is None:
            endpoint, bucket, prefix = _parse_objstore_url(url)
            client = ObjectStoreClient(endpoint, bucket, token=token)
        else:
            prefix = getattr(client, "_fleet_prefix", "")
        self.url = url
        self.flow = flow
        self.replica = replica
        self.replica_index = int(replica_index)
        self.replica_count = int(replica_count)
        self.window_s = float(window_s)
        self.metric_logger = metric_logger
        self.histograms = histograms if histograms is not None else HISTOGRAMS
        self._client = client
        self._prefix = prefix
        self._now = now_fn
        self._lock = threading.Lock()
        self._window_id = 0
        self._window_start_ms: Optional[int] = None
        self._window_opened_at: Optional[float] = None
        # window accumulators (reset only on a SUCCESSFUL publish)
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._offsets: Dict[str, List] = {}   # "src:part" -> [lo, hi]
        self._ingested: Dict[str, float] = {}  # source -> events
        self._emitted: Dict[str, float] = {}   # output -> events
        self._batches = 0
        self._last_batch_time_ms: Optional[int] = None
        self._last_health: Optional[dict] = None
        self._last_alerts: List[dict] = []
        self._killed = False
        # lifetime self-metrics (exported through metric_logger and on
        # every frame)
        self.frames_published = 0
        self.publish_errors = 0
        self.last_frame_bytes = 0
        self.last_publish_ms = 0.0

    @classmethod
    def from_conf(cls, dict_, flow: str, metric_logger=None,
                  histograms=None) -> Optional["TelemetryFramePublisher"]:
        """Build from ``datax.job.process.fleet.*`` conf; None when no
        ``publishurl`` is conf'd (fleet telemetry off)."""
        fleet_conf = dict_.get_sub_dictionary(
            SettingNamespace.JobProcessPrefix + "fleet."
        )
        url = fleet_conf.get("publishurl")
        if not url:
            return None
        state_conf = dict_.get_sub_dictionary(
            SettingNamespace.JobProcessPrefix + "state."
        )
        replica_index = int(state_conf.get_or_else("replicaindex", "1"))
        replica_count = int(state_conf.get_or_else("replicacount", "1"))
        try:
            return cls(
                url,
                flow=flow,
                replica=fleet_conf.get_or_else(
                    "replica", f"r{replica_index}"
                ),
                replica_index=replica_index,
                replica_count=replica_count,
                window_s=float(
                    fleet_conf.get_or_else("windowseconds", "10")
                ),
                metric_logger=metric_logger,
                histograms=histograms,
            )
        except Exception:  # noqa: BLE001 — telemetry init never kills a host
            logger.exception(
                "fleet publisher init failed (publishurl=%s); "
                "fleet telemetry disabled for this host", url
            )
            return None

    # -- accumulation -----------------------------------------------------
    def record_batch(
        self,
        metrics: Dict[str, float],
        consumed: Optional[Dict] = None,
        batch_time_ms: Optional[int] = None,
        health: Optional[dict] = None,
        alerts: Optional[List[dict]] = None,
    ) -> None:
        """Fold one finished batch into the open window; publishes the
        frame when the window has elapsed (``window_s`` 0 publishes
        every batch). Thread-safe; never raises."""
        try:
            with self._lock:
                if self._killed:
                    return
                now = self._now()
                if self._window_opened_at is None:
                    self._window_opened_at = now
                    self._window_start_ms = batch_time_ms
                for name, value in metrics.items():
                    try:
                        v = float(value)
                    except (TypeError, ValueError):
                        continue
                    if is_counter_metric(name):
                        self._counters[name] = (
                            self._counters.get(name, 0.0) + v
                        )
                        if name.startswith("Input_") \
                                and name.endswith("_Events_Count"):
                            src = name[len("Input_"):-len("_Events_Count")]
                            self._ingested[src] = (
                                self._ingested.get(src, 0.0) + v
                            )
                        elif name.startswith("Output_") \
                                and name.endswith("_Events_Count"):
                            out = name[len("Output_"):-len("_Events_Count")]
                            self._emitted[out] = (
                                self._emitted.get(out, 0.0) + v
                            )
                    else:
                        self._gauges[name] = v
                for key, rng in (consumed or {}).items():
                    if isinstance(key, tuple):
                        key = ":".join(str(k) for k in key)
                    try:
                        lo, hi = rng
                    except (TypeError, ValueError):
                        continue
                    cur = self._offsets.get(str(key))
                    if cur is None:
                        self._offsets[str(key)] = [lo, hi]
                    else:
                        cur[0] = min(cur[0], lo)
                        cur[1] = max(cur[1], hi)
                self._batches += 1
                if batch_time_ms is not None:
                    self._last_batch_time_ms = batch_time_ms
                if health is not None:
                    self._last_health = health
                if alerts is not None:
                    self._last_alerts = list(alerts)
                due = now - self._window_opened_at >= self.window_s
            if due:
                self.flush()
        except Exception:  # noqa: BLE001 — fail-open: telemetry never
            logger.exception("fleet frame accumulation failed")  # kills a batch

    # -- publication ------------------------------------------------------
    def _build_frame(self, final: bool) -> dict:
        hists = {}
        for f, stage, h in self.histograms.items():
            if f == self.flow:
                hists[stage] = h.to_state()
        now_ms = int(self._now() * 1000)
        return {
            "version": FRAME_VERSION,
            "flow": self.flow,
            "replica": self.replica,
            "replicaIndex": self.replica_index,
            "replicaCount": self.replica_count,
            "window": self._window_id,
            "windowSeconds": self.window_s,
            "windowStartMs": self._window_start_ms,
            "publishedAtMs": now_ms,
            "final": final,
            "batches": self._batches,
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": hists,
            "alerts": list(self._last_alerts),
            "health": self._last_health,
            "watermark": {
                "batchTimeMs": self._last_batch_time_ms,
                "offsets": {k: list(v) for k, v in self._offsets.items()},
            },
            "delivery": {
                "ingested": dict(self._ingested),
                "emitted": dict(self._emitted),
            },
            "framesPublished": self.frames_published,
            "publishErrors": self.publish_errors,
        }

    def _frame_key(self) -> str:
        parts = [
            self._prefix, "fleet", self.flow, self.replica,
            f"{self._window_id:08d}.json",
        ]
        return "/".join(p for p in parts if p)

    def flush(self, final: bool = False) -> bool:
        """Publish the open window (even if empty when ``final`` — the
        drain marker must ship). Returns True on success; on failure
        the accumulators are retained for the next attempt."""
        with self._lock:
            if self._killed:
                return False
            if self._batches == 0 and not final:
                return True  # nothing to ship yet
            frame = self._build_frame(final)
            key = self._frame_key()
        body = json.dumps(frame, default=str).encode("utf-8")
        t0 = self._now()
        try:
            self._client.put(key, body)
        except Exception:  # noqa: BLE001 — fail-open by contract
            with self._lock:
                self.publish_errors += 1
            logger.warning(
                "fleet frame publish failed (%s); window retained "
                "(%d error(s) so far)", key, self.publish_errors,
                exc_info=True,
            )
            self._send_self_metric(
                MetricName.FLEET_FRAME_PUBLISH_ERROR,
                float(self.publish_errors),
            )
            return False
        publish_ms = (self._now() - t0) * 1000.0
        with self._lock:
            self.frames_published += 1
            self.last_frame_bytes = len(body)
            self.last_publish_ms = publish_ms
            self._window_id += 1
            self._window_opened_at = None
            self._window_start_ms = None
            self._counters.clear()
            self._gauges.clear()
            self._offsets.clear()
            self._ingested.clear()
            self._emitted.clear()
            self._batches = 0
            frames = self.frames_published
        self._send_self_metric(MetricName.FLEET_FRAMES, float(frames))
        self._send_self_metric(MetricName.FLEET_FRAME_BYTES, float(len(body)))
        self._send_self_metric(MetricName.FLEET_FRAME_PUBLISH_MS, publish_ms)
        return True

    def kill(self) -> None:
        """Chaos hook: stop publishing WITHOUT the final drain frame —
        the telemetry shape of a replica killed without drain. The
        fleet view must then mark this replica stale (DX542) once it
        goes quiet (serve/scenarios.py rescale drill)."""
        with self._lock:
            self._killed = True

    def _send_self_metric(self, metric: str, value: float) -> None:
        if self.metric_logger is None:
            return
        try:
            self.metric_logger.send_metric(
                metric, value, int(self._now() * 1000)
            )
        except Exception:  # noqa: BLE001 — self-metrics are best-effort
            logger.debug("fleet self-metric %s emit failed", metric)
