"""Metrics ingestor side-car: metric event stream -> metric store.

reference: Services/DataX.Metrics/DataX.Metrics.Ingestor — a stateless
service running an EventProcessorHost over the metrics EventHub
(Ingestor.cs:108-150); each event body is newline-split, each line parsed
into ``{app, metric, uts, value}`` and written to a Redis sorted set
keyed ``app:metric`` scored by epoch millis
(IngestorEventProcessor.cs:92-96,141). Bad lines are logged and skipped,
never failing the batch.

TPU-native stand-in: the metric stream is newline-delimited JSON over
TCP (the same DCN wire format the engine's StreamSink speaks), consumed
by an acceptor thread per connection — connection-per-producer plays the
role of EventProcessorHost's partition leases (each producer's stream is
owned by exactly one reader thread). Rows land in a MetricStore
(obs/store.py, the Redis analog) that the dashboard feed reads.

The producer side is ``MetricStreamSender`` — plugged into
MetricLogger's ``eventhub_sender`` hook so a job emits metrics over the
wire exactly like the reference's EventHub metric sink
(MetricLogger.scala:60-63).

Copy of the JAX package's ``obs/ingestor.py``, unchanged:
``MetricLogger.from_conf`` imports ``MetricStreamSender`` for
``process.metric.eventhub=host:port``.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional

from .store import METRIC_STORE, MetricStore

logger = logging.getLogger(__name__)


class MetricsIngestor:
    """TCP server ingesting metric JSON lines into a MetricStore."""

    def __init__(
        self,
        store: Optional[MetricStore] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.store = store if store is not None else METRIC_STORE
        self.messages_received = 0
        self.metrics_sent = 0
        self.parse_errors = 0
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(8)
        self.port = self._server.getsockname()[1]
        self._closing = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            # one reader per producer connection — the partition-lease
            # analog: a producer's ordered stream has a single owner
            threading.Thread(target=self._reader, args=(conn,), daemon=True).start()

    def _reader(self, conn) -> None:
        with conn:
            f = conn.makefile("rb")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                self.messages_received += 1
                self.ingest_line(line.decode("utf-8", errors="replace"))

    def ingest_line(self, line: str) -> bool:
        """Parse one metric line and store it; bad lines are counted and
        skipped (GenerateRow's per-line try/catch)."""
        try:
            item = json.loads(line)
            app = item["app"]
            metric = item["metric"]
            uts = int(item.get("uts") or item.get("EventTime"))
            value = item["value"]
        except (ValueError, KeyError, TypeError) as e:
            self.parse_errors += 1
            logger.warning("bad metric line %r: %s", line[:200], e)
            return False
        key = f"{app}:{metric}" if not metric.startswith(app) else metric
        self.store.add_point(key, uts, value)
        self.metrics_sent += 1
        return True

    def close(self) -> None:
        self._closing = True
        try:
            self._server.close()
        except OSError:
            pass

    # lifecycle alias so service composition can stop() every part
    stop = close


class MetricStreamSender:
    """Producer half: ships metric points over TCP to the ingestor.

    Callable with ``(key, uts_ms, value)`` so it plugs straight into
    MetricLogger's ``eventhub_sender`` hook. The key arrives already
    namespaced (``DATAX-<flow>:<metric>``); it is split back into
    app/metric like the reference's metric JSON carries both fields.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self._sock = None
        self._lock = threading.Lock()

    def _connect(self):
        return socket.create_connection(self.addr, timeout=self.timeout_s)

    def __call__(self, key: str, uts_ms: int, value) -> None:
        app, _, metric = key.partition(":")
        payload = json.dumps(
            {"app": app, "metric": metric, "uts": int(uts_ms), "value": value},
            default=str,
        ).encode() + b"\n"
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.sendall(payload)
            except OSError as e:
                # metrics never fail the batch: drop after one reconnect try
                try:
                    if self._sock is not None:
                        self._sock.close()
                    self._sock = self._connect()
                    self._sock.sendall(payload)
                except OSError:
                    self._sock = None
                    logger.warning("metric send to %s failed: %s", self.addr, e)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
