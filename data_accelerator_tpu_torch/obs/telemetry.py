"""Telemetry: structured lifecycle events + exceptions with context props.

reference: datax-host telemetry/AppInsightLogger.scala:18-108 — a
process-wide logger that stamps every event/exception with context
properties (app name, executor/driver id) and ships them to AppInsights;
the engine emits events like ``streaming/batch/begin|end`` around every
micro-batch (EventHubStreamingFactory.scala:88,115) and
``error/streaming/process`` on batch failure
(CommonProcessorFactory.scala:382-398). The ASP.NET services do the same
via DataX.Utilities.Telemetry.

TPU-native stand-in: writers are pluggable — process log, JSONL trace
file (greppable flight recorder), and HTTP POST (a collector endpoint
under k8s).

Copy of the JAX package's ``obs/telemetry.py``; only its logger's name
and this note differ.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
import traceback
import urllib.request
from typing import Any, Dict, List, Optional

logger = logging.getLogger("data_accelerator_tpu_torch.telemetry")


class TelemetryWriter:
    def write(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError


class LogWriter(TelemetryWriter):
    def write(self, record: Dict[str, Any]) -> None:
        # serialise only for a log that keeps INFO: a span is written
        # on the hot path of every batch
        if logger.isEnabledFor(logging.INFO):
            logger.info("%s", json.dumps(record, default=str))


class JsonlWriter(TelemetryWriter):
    """Append-only JSONL trace file — the local flight recorder.

    Size-capped: when the file would exceed ``max_bytes`` it rotates
    through ``<path>.1 .. <path>.N`` (``keep`` segments, oldest
    dropped), so a long-running job keeps at most ~(keep+1)x the cap on
    disk while the trace CLI can still reconstruct up to ``keep`` caps
    of history from the rotated segments. With ``compress`` the rotated
    segments are gzipped (``<path>.N.gz``) — the active file always
    stays plain text so `tail -f`/grep keep working. Rotation is a
    whole-file rename: a record (and therefore a span line) is never
    split across segments, so an in-progress batch's spans survive any
    rotation — some may land in ``.1`` while later ones land in the
    fresh active file, and the trace reader stitches them back.

    One append handle stays open, flushed after every record so a crash
    loses none; it is reopened when the path no longer names its file
    (rotated here or by another writer of the same path, or removed).
    """

    DEFAULT_MAX_BYTES = 64 * 1024 * 1024

    def __init__(
        self,
        path: str,
        max_bytes: int = DEFAULT_MAX_BYTES,
        keep: int = 1,
        compress: bool = False,
    ):
        self.path = path
        self.max_bytes = max_bytes
        self.keep = max(1, int(keep))
        self.compress = bool(compress)
        self._lock = threading.Lock()
        self._f = None
        self._ino = None
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0

    @property
    def rotated_path(self) -> str:
        return self.path + (".1.gz" if self.compress else ".1")

    def _segment(self, i: int) -> str:
        return f"{self.path}.{i}" + (".gz" if self.compress else "")

    def _rotate(self) -> None:
        try:
            # shift .N-1 -> .N (dropping the oldest), then the active
            # file becomes .1 — gzipped first when compress is on
            for i in range(self.keep, 1, -1):
                if os.path.exists(self._segment(i - 1)):
                    os.replace(self._segment(i - 1), self._segment(i))
            if self.compress:
                import gzip
                import shutil

                with open(self.path, "rb") as src, gzip.open(
                    self._segment(1), "wb"
                ) as dst:
                    shutil.copyfileobj(src, dst)
                os.remove(self.path)
            else:
                os.replace(self.path, self._segment(1))
        except OSError:
            pass  # rotation failure must not lose the record

    def _handle(self):
        """The open append handle of the file the path names now."""
        try:
            ino = os.stat(self.path).st_ino
        except OSError:
            ino = None
        if self._f is None or ino != self._ino:
            self.close()
            self._f = open(self.path, "a", encoding="utf-8")
            self._ino = os.fstat(self._f.fileno()).st_ino
        return self._f

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    __del__ = close

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str) + "\n"
        data = line.encode("utf-8")
        with self._lock:
            if self.max_bytes and self._size + len(data) > self.max_bytes \
                    and self._size > 0:
                self.close()
                self._rotate()
                self._size = 0
            f = self._handle()
            f.write(line)
            f.flush()
            self._size += len(data)


class HttpWriter(TelemetryWriter):
    """Fire-and-forget POST to a collector (telemetry never fails the job).

    One worker thread drains a bounded queue; records are dropped (not
    queued unboundedly) when the collector is slow or down.
    """

    def __init__(self, endpoint: str, timeout_s: float = 5.0, max_queue: int = 1000):
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self._queue: "queue.Queue[Dict[str, Any]]" = queue.Queue(maxsize=max_queue)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        while True:
            record = self._queue.get()
            try:
                req = urllib.request.Request(
                    self.endpoint,
                    data=json.dumps(record, default=str).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=self.timeout_s).read()
            except Exception as e:  # noqa: BLE001
                logger.debug("telemetry post failed: %s", e)

    def write(self, record: Dict[str, Any]) -> None:
        try:
            self._queue.put_nowait(record)
        except queue.Full:
            logger.debug("telemetry queue full; dropping record")


class TelemetryLogger:
    """Event/exception tracker with sticky context properties.

    reference: AppInsightLogger.scala — trackEvent/trackException with
    per-process context (app name, node role) merged into every record.
    """

    def __init__(
        self,
        app_name: str = "",
        writers: Optional[List[TelemetryWriter]] = None,
        context: Optional[Dict[str, str]] = None,
    ):
        self.app_name = app_name
        self.writers: List[TelemetryWriter] = (
            writers if writers is not None else [LogWriter()]
        )
        self.context: Dict[str, str] = {"app": app_name, **(context or {})}

    def with_context(self, **props: str) -> "TelemetryLogger":
        """Derived logger with extra sticky props (e.g. executor id)."""
        t = TelemetryLogger(self.app_name, self.writers, {**self.context, **props})
        return t

    def _emit(self, record: Dict[str, Any]) -> None:
        record = {"ts": time.time(), **self.context, **record}
        for w in self.writers:
            try:
                w.write(record)
            except Exception as e:  # noqa: BLE001 — never fail the caller
                logger.debug("telemetry writer failed: %s", e)

    def track_event(
        self,
        name: str,
        properties: Optional[Dict[str, Any]] = None,
        measurements: Optional[Dict[str, float]] = None,
    ) -> None:
        """reference: AppInsightLogger.trackEvent — e.g.
        ``streaming/batch/begin`` with batch-time props."""
        self._emit({
            "type": "event",
            "name": name,
            "properties": properties or {},
            "measurements": measurements or {},
        })

    def track_exception(
        self, error: BaseException, properties: Optional[Dict[str, Any]] = None
    ) -> None:
        self._emit({
            "type": "exception",
            "error": f"{type(error).__name__}: {error}",
            "stack": "".join(
                traceback.format_exception(
                    type(error), error, error.__traceback__
                )
            ),
            "properties": properties or {},
        })

    def track_span(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        start_ts: float,
        duration_ms: float,
        properties: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One batch-stage span (obs/tracing.py) — written through the
        same fan-out as events, so the JSONL flight recorder is also the
        trace log the ``obs trace`` CLI reconstructs from."""
        self._emit({
            "type": "span",
            "name": name,
            "trace": trace_id,
            "span": span_id,
            "parent": parent_id,
            "startTs": start_ts,
            "durationMs": round(float(duration_ms), 4),
            "properties": properties or {},
        })

    def track_metric(self, name: str, value: float,
                     properties: Optional[Dict[str, Any]] = None) -> None:
        self._emit({
            "type": "metric", "name": name, "value": value,
            "properties": properties or {},
        })

    # -- batch lifecycle convenience (the engine's event vocabulary) ------
    def batch_begin(self, batch_time_ms: int) -> None:
        self.track_event(
            "streaming/batch/begin", {"batchTime": batch_time_ms}
        )

    def batch_end(self, batch_time_ms: int,
                  measurements: Optional[Dict[str, float]] = None) -> None:
        self.track_event(
            "streaming/batch/end", {"batchTime": batch_time_ms}, measurements
        )


def from_conf(dict_) -> TelemetryLogger:
    """Build from ``datax.job.process.telemetry.*`` conf: ``tracefile``
    (JSONL path) and ``httppost`` (collector endpoint) writers plus the
    process log, mirroring the reference's appinsights conf gate
    (AppHost init path). ``tracefile.keep`` (rotated-segment count,
    default 1) and ``tracefile.compress`` (gzip rotated segments,
    default false) tune the flight recorder's rotation."""
    sub = dict_.get_sub_dictionary("datax.job.process.telemetry.")
    writers: List[TelemetryWriter] = [LogWriter()]
    trace = sub.get("tracefile")
    if trace:
        max_bytes = sub.get_long_option("tracefilemaxbytes")
        keep = sub.get_int_option("tracefile.keep")
        writers.append(JsonlWriter(
            trace,
            max_bytes=(
                max_bytes if max_bytes is not None
                else JsonlWriter.DEFAULT_MAX_BYTES
            ),
            keep=keep if keep is not None else 1,
            compress=(
                (sub.get_or_else("tracefile.compress", "false") or "")
                .lower() == "true"
            ),
        ))
    endpoint = sub.get("httppost")
    if endpoint:
        writers.append(HttpWriter(endpoint))
    return TelemetryLogger(dict_.get_metric_app_name(), writers)
