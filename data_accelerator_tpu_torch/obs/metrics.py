"""MetricLogger: fan-out of named metric points to configured sinks.

reference: datax-host telemetry/MetricLogger.scala:14-100 — metrics named
``DATAX-<flow>:<metric>`` go to Redis sorted sets, an EventHub, and/or an
HTTP endpoint depending on ``process.metric.*`` conf. Here: the in-proc
MetricStore stands in for Redis (one-box), HTTP POST is kept
wire-compatible with the local-mode website endpoint
(MetricLogger.scala:65-69), and an eventhub sink is a stub hook.

Copy of the JAX package's ``obs/metrics.py``, unchanged.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Dict, Iterable, Optional

from ..core.config import SettingDictionary
from .store import METRIC_STORE, MetricStore

logger = logging.getLogger(__name__)


class MetricLogger:
    def __init__(
        self,
        metric_app_name: str,
        store: Optional[MetricStore] = None,
        http_endpoint: Optional[str] = None,
        eventhub_sender=None,
    ):
        self.app_name = metric_app_name  # "DATAX-<flow>"
        self.store = store if store is not None else METRIC_STORE
        self.http_endpoint = http_endpoint
        self.eventhub_sender = eventhub_sender

    @staticmethod
    def from_conf(dict_: SettingDictionary) -> "MetricLogger":
        """reference: MetricsHandler.scala:12-35 reads
        process.metric.{redis,eventhub,httppost}. An ``eventhub`` value
        of ``host:port`` ships points to a MetricsIngestor side-car over
        TCP (the metrics-EventHub path, MetricLogger.scala:60-63)."""
        sub = dict_.get_sub_dictionary("datax.job.process.metric.")
        eventhub_sender = None
        conn = sub.get("eventhub") or ""
        h, _, p = conn.rpartition(":")
        if p.isdigit():
            from .ingestor import MetricStreamSender

            eventhub_sender = MetricStreamSender(h or "127.0.0.1", int(p))
        # the redis-analog sink: unset or any connection-ish value keeps
        # the shared in-proc MetricStore (the one-box stand-in for the
        # reference's Redis — the dashboard reads it back); an explicit
        # disable word detaches the job from the dashboard feed, the
        # analog of a reference job deployed with no redis connection
        redis = (sub.get("redis") or "").strip().lower()
        store = MetricStore() if redis in (
            "false", "off", "none", "disabled", "0",
        ) else None
        return MetricLogger(
            metric_app_name=dict_.get_metric_app_name(),
            store=store,
            http_endpoint=sub.get("httppost"),
            eventhub_sender=eventhub_sender,
        )

    def key(self, metric: str) -> str:
        return f"{self.app_name}:{metric}"

    def send_metric(self, metric: str, value, uts_ms: Optional[int] = None) -> None:
        if uts_ms is None:
            uts_ms = int(time.time() * 1000)
        self.store.add_point(self.key(metric), uts_ms, value)
        if self.http_endpoint:
            self._post_async([{"app": self.app_name, "metric": metric,
                              "uts": uts_ms, "value": value}])
        if self.eventhub_sender is not None:
            self.eventhub_sender(self.key(metric), uts_ms, value)

    def send_batch_metrics(
        self, metrics: Dict[str, float], uts_ms: Optional[int] = None
    ) -> None:
        """reference: MetricLogger.scala sendBatchMetrics via
        CommonProcessorFactory.scala:344-379."""
        for name, value in metrics.items():
            self.send_metric(name, value, uts_ms)

    def send_metric_events(
        self, metric: str, events: Iterable[dict], uts_ms: Optional[int] = None
    ) -> None:
        """Detail events (alert tables routed TO Metrics): stored as JSON
        members so DirectTable widgets can render rows
        (reference: metric sink rows with EventTime/MetricName/Pivot1)."""
        if uts_ms is None:
            uts_ms = int(time.time() * 1000)
        for ev in events:
            self.store.zadd(self.key(metric), float(uts_ms), json.dumps(ev, default=str))

    def _post_async(self, payload) -> None:
        def post():
            try:
                req = urllib.request.Request(
                    self.http_endpoint,
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=5).read()
            except Exception as e:  # metrics must never fail the batch
                logger.warning("metric http post failed: %s", e)

        threading.Thread(target=post, daemon=True).start()
