"""Prometheus/health surface: ``/metrics``, ``/healthz``, ``/readyz``.

reference: the reference leans on AppInsights' live-metrics dashboard
(SURVEY §1 "live metrics dashboard") and k8s-style probes on the ASP.NET
services; the TPU-native runtime exposes the same operational contract
directly:

- ``GET /metrics``  — Prometheus text format: per-stage latency
  histograms (``datax_stage_latency_ms``), engine gauges (latest value
  of every MetricStore key), and health gauges (checkpoint age,
  batches/failures totals).
- ``GET /healthz``  — liveness: the process is serving; payload carries
  last-batch status for humans. Always 200 while the server runs.
- ``GET /readyz``   — readiness: 200 only when the engine has processed
  a batch recently, the last batch succeeded, and the checkpoint is not
  stale; 503 with the failing reasons otherwise.

The same rendering functions back the website server's endpoints, so
the control plane and every runtime host speak one exposition dialect.

Copy of the JAX package's ``obs/exposition.py``; ``GET /profile`` and
``POST /profile?seconds=N`` drive the port's ``torch.profiler`` surface
(``obs/profiler.py``).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .histogram import HISTOGRAMS, HistogramRegistry
from .store import METRIC_STORE, MetricStore

logger = logging.getLogger(__name__)


class HealthState:
    """Mutable health snapshot a host updates as it runs.

    The readiness contract (readyz) derives from it: batch recency,
    last-batch success, checkpoint age.
    """

    # default EWMA weight for the pipeline-stall gauge (recent batches
    # dominate but one outlier stall can't flip readiness on its own);
    # conf ``observability.stallewmams`` overrides it as a HALF-LIFE in
    # milliseconds of batch time — see ``stall_ewma_half_life_ms``
    STALL_EWMA_ALPHA = 0.3

    def __init__(
        self,
        flow: str = "",
        checkpoint_interval_s: Optional[float] = None,
        batch_interval_s: float = 1.0,
        stall_fail_ms: Optional[float] = None,
        stall_ewma_half_life_ms: Optional[float] = None,
    ):
        self.flow = flow
        self.checkpoint_interval_s = checkpoint_interval_s
        self.batch_interval_s = batch_interval_s
        # sustained-stall readiness threshold: the smoothed
        # Pipeline_Stall_Ms above this means the pipeline is saturated
        # or wedged, not merely overlapping (default: 10 batch
        # intervals, floored at 10 s so split-host tunnel RTTs and
        # normal overlap never trip it)
        self.stall_fail_ms = (
            stall_fail_ms if stall_fail_ms is not None
            else max(10_000.0, 10.0 * batch_interval_s * 1000.0)
        )
        # smoothing weight for record_stall: conf'd as a half-life in
        # ms of batch time (observability.stallewmams — after one
        # half-life of batches a level shift covers half the distance),
        # converted to the per-sample alpha here; absent, the legacy
        # STALL_EWMA_ALPHA applies. The pilot reads the RESULTING gauge
        # (pipeline_stall_ms), so whatever constant readiness judges,
        # the controller judges too.
        if stall_ewma_half_life_ms is not None and stall_ewma_half_life_ms > 0:
            self.stall_ewma_alpha = 1.0 - 0.5 ** (
                max(1e-3, batch_interval_s * 1000.0)
                / float(stall_ewma_half_life_ms)
            )
        else:
            self.stall_ewma_alpha = self.STALL_EWMA_ALPHA
        self.started_at = time.time()
        self.batches_processed = 0
        self.batches_failed = 0
        self.last_batch_time_ms: Optional[int] = None
        self.last_batch_at: Optional[float] = None
        self.last_batch_ok: Optional[bool] = None
        self.last_batch_latency_ms: Optional[float] = None
        self.last_error: Optional[str] = None
        self.last_checkpoint_at: Optional[float] = None
        self.source_watermark_ms: Optional[int] = None
        self.pipeline_stall_ms: Optional[float] = None  # EWMA
        self.firing_alerts: List[dict] = []
        self._lock = threading.Lock()

    # -- host-side updates -------------------------------------------------
    def record_batch(
        self, batch_time_ms: Optional[int], ok: bool,
        latency_ms: Optional[float] = None, error: Optional[str] = None,
    ) -> None:
        with self._lock:
            if ok:
                self.batches_processed += 1
            else:
                self.batches_failed += 1
                self.last_error = error
            if batch_time_ms is not None:
                self.last_batch_time_ms = batch_time_ms
            self.last_batch_at = time.time()
            self.last_batch_ok = ok
            if latency_ms is not None:
                self.last_batch_latency_ms = latency_ms

    def record_checkpoint(self) -> None:
        with self._lock:
            self.last_checkpoint_at = time.time()

    def record_watermark(self, watermark_ms: int) -> None:
        """Latest event-time high-water mark the engine has processed
        (source lag = wall clock - watermark)."""
        with self._lock:
            self.source_watermark_ms = watermark_ms

    def record_stall(self, stall_ms: float) -> None:
        """Feed one batch's ``Pipeline_Stall_Ms`` into the smoothed
        stall gauge the readiness probe (and the pilot) judge."""
        a = self.stall_ewma_alpha
        with self._lock:
            prev = self.pipeline_stall_ms
            self.pipeline_stall_ms = (
                float(stall_ms) if prev is None
                else a * float(stall_ms) + (1.0 - a) * prev
            )

    def record_alerts(self, firing: List[dict]) -> None:
        """Latest firing-alert set from the host's AlertEngine — probes
        report it so k8s (and humans curling /readyz) see degradation,
        not just liveness."""
        with self._lock:
            self.firing_alerts = list(firing)

    # -- probes ------------------------------------------------------------
    def health(self) -> Dict[str, object]:
        with self._lock:
            now = time.time()
            return {
                "status": "ok" if self.last_batch_ok in (None, True)
                else "degraded",
                "flow": self.flow,
                "uptimeSeconds": round(now - self.started_at, 3),
                "batchesProcessed": self.batches_processed,
                "batchesFailed": self.batches_failed,
                "lastBatchTimeMs": self.last_batch_time_ms,
                "lastBatchOk": self.last_batch_ok,
                "lastBatchLatencyMs": self.last_batch_latency_ms,
                "lastBatchAgeSeconds": (
                    None if self.last_batch_at is None
                    else round(now - self.last_batch_at, 3)
                ),
                "lastError": self.last_error,
                "checkpointAgeSeconds": self.checkpoint_age_s(now),
                "sourceLagMs": self.source_lag_ms(now),
                "pipelineStallMs": (
                    None if self.pipeline_stall_ms is None
                    else round(self.pipeline_stall_ms, 1)
                ),
                "firingAlerts": [
                    a.get("name") for a in self.firing_alerts
                ],
            }

    def checkpoint_age_s(self, now: Optional[float] = None) -> Optional[float]:
        if self.last_checkpoint_at is None:
            return None
        return round((now or time.time()) - self.last_checkpoint_at, 3)

    def source_lag_ms(self, now: Optional[float] = None) -> Optional[float]:
        if self.source_watermark_ms is None:
            return None
        return round((now or time.time()) * 1000.0 - self.source_watermark_ms, 1)

    def readiness(self) -> List[str]:
        """Empty list when ready; otherwise the failing reasons."""
        reasons: List[str] = []
        with self._lock:
            now = time.time()
            if self.batches_processed == 0:
                reasons.append("no batch processed yet")
            if self.last_batch_ok is False:
                reasons.append(f"last batch failed: {self.last_error}")
            if self.last_batch_at is not None:
                stale_after = max(10.0, 5.0 * self.batch_interval_s)
                age = now - self.last_batch_at
                if age > stale_after:
                    reasons.append(
                        f"no batch for {age:.1f}s (> {stale_after:.1f}s)"
                    )
            if (
                self.checkpoint_interval_s is not None
                and self.last_checkpoint_at is not None
            ):
                age = now - self.last_checkpoint_at
                if age > 3.0 * self.checkpoint_interval_s:
                    reasons.append(
                        f"checkpoint stale: {age:.1f}s "
                        f"(interval {self.checkpoint_interval_s:.0f}s)"
                    )
            if (
                self.pipeline_stall_ms is not None
                and self.pipeline_stall_ms > self.stall_fail_ms
            ):
                reasons.append(
                    f"sustained pipeline stall: "
                    f"{self.pipeline_stall_ms:.0f}ms smoothed "
                    f"(> {self.stall_fail_ms:.0f}ms)"
                )
        return reasons


# -- Prometheus text rendering ---------------------------------------------
def _esc(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(
    histograms: Optional[HistogramRegistry] = None,
    store: Optional[MetricStore] = None,
    health: Optional[HealthState] = None,
    alerts=None,
) -> str:
    """All process observability as Prometheus text exposition v0.0.4.

    ``alerts``: an ``obs.alerts.AlertEngine`` — per-rule
    ``datax_alert_firing`` gauges plus the ``datax_alerts_firing``
    total, evaluated at scrape time so ``GET /alerts`` and this
    exposition can never disagree on the firing set."""
    histograms = histograms if histograms is not None else HISTOGRAMS
    out: List[str] = []

    items = histograms.items()
    if items:
        out.append(
            "# HELP datax_stage_latency_ms Per-stage micro-batch latency."
        )
        out.append("# TYPE datax_stage_latency_ms histogram")
        for flow, stage, hist in sorted(items, key=lambda t: (t[0], t[1])):
            snap = hist.snapshot()
            labels = f'flow="{_esc(flow)}",stage="{_esc(stage)}"'
            for bound, cum in zip(snap["buckets"], snap["cumulative"]):
                out.append(
                    f'datax_stage_latency_ms_bucket{{{labels},'
                    f'le="{_fmt(bound)}"}} {cum}'
                )
            # OpenMetrics-style exemplar on the +Inf bucket: the trace
            # id of the window's max-duration observation, so a p99
            # spike on a dashboard links to `obs trace <id>` directly
            ex = hist.exemplar()
            ex_s = (
                f' # {{trace_id="{_esc(ex["traceId"])}"}} '
                f'{_fmt(ex["ms"])}'
                if ex and ex.get("traceId") else ""
            )
            out.append(
                f'datax_stage_latency_ms_bucket{{{labels},le="+Inf"}} '
                f'{snap["count"]}{ex_s}'
            )
            out.append(
                f'datax_stage_latency_ms_sum{{{labels}}} '
                f'{_fmt(snap["sum_ms"])}'
            )
            out.append(
                f'datax_stage_latency_ms_count{{{labels}}} {snap["count"]}'
            )

    if store is not None:
        keys = store.keys()
        if keys:
            out.append(
                "# HELP datax_metric_last_value Latest engine metric point "
                "per DATAX-<flow>:<metric> key."
            )
            out.append("# TYPE datax_metric_last_value gauge")
            for key in sorted(keys):
                pts = store.points(key)
                if not pts:
                    continue
                last = pts[-1]
                val = last.get("val")
                if not isinstance(val, (int, float)) or isinstance(val, bool):
                    continue  # detail-event members are JSON rows, not gauges
                app, _, metric = key.partition(":")
                out.append(
                    f'datax_metric_last_value{{app="{_esc(app)}",'
                    f'metric="{_esc(metric)}"}} {_fmt(val)}'
                )

    if health is not None:
        h = health.health()
        labels = f'flow="{_esc(health.flow)}"'
        out.append("# TYPE datax_batches_processed_total counter")
        out.append(
            f'datax_batches_processed_total{{{labels}}} '
            f'{h["batchesProcessed"]}'
        )
        out.append("# TYPE datax_batches_failed_total counter")
        out.append(
            f'datax_batches_failed_total{{{labels}}} {h["batchesFailed"]}'
        )
        out.append("# TYPE datax_last_batch_ok gauge")
        out.append(
            f'datax_last_batch_ok{{{labels}}} '
            f'{1 if h["lastBatchOk"] in (True, None) else 0}'
        )
        if h["checkpointAgeSeconds"] is not None:
            out.append("# TYPE datax_checkpoint_age_seconds gauge")
            out.append(
                f'datax_checkpoint_age_seconds{{{labels}}} '
                f'{_fmt(h["checkpointAgeSeconds"])}'
            )
        if h["sourceLagMs"] is not None:
            out.append("# TYPE datax_source_lag_ms gauge")
            out.append(
                f'datax_source_lag_ms{{{labels}}} {_fmt(h["sourceLagMs"])}'
            )
        if h["pipelineStallMs"] is not None:
            out.append("# TYPE datax_pipeline_stall_ms gauge")
            out.append(
                f'datax_pipeline_stall_ms{{{labels}}} '
                f'{_fmt(h["pipelineStallMs"])}'
            )

    if alerts is not None:
        snap = alerts.snapshot()
        firing_names = {a["name"] for a in snap["firing"]}
        out.append(
            "# HELP datax_alert_firing 1 when the named alert rule is "
            "firing."
        )
        out.append("# TYPE datax_alert_firing gauge")
        for rule in snap["rules"]:
            out.append(
                f'datax_alert_firing{{flow="{_esc(snap["flow"])}",'
                f'rule="{_esc(rule["name"])}",'
                f'severity="{_esc(rule.get("severity") or "warn")}"}} '
                f'{1 if rule["name"] in firing_names else 0}'
            )
        out.append("# TYPE datax_alerts_firing gauge")
        out.append(
            f'datax_alerts_firing{{flow="{_esc(snap["flow"])}"}} '
            f'{len(firing_names)}'
        )
    return "\n".join(out) + "\n"


# -- the runtime host's observability server -------------------------------
class ObservabilityServer:
    """Tiny HTTP server exposing /metrics, /healthz, /readyz for one
    runtime host (the website server exposes the same paths for the
    control plane via web/server.py)."""

    def __init__(
        self,
        health: HealthState,
        histograms: Optional[HistogramRegistry] = None,
        store: Optional[MetricStore] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        alerts=None,
        profiler=None,
    ):
        self.health = health
        self.histograms = histograms if histograms is not None else HISTOGRAMS
        self.store = store if store is not None else METRIC_STORE
        self.alerts = alerts  # obs.alerts.AlertEngine | None
        self.profiler = profiler  # obs.profiler.ProfilerSurface | None
        obs = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("obs %s", fmt % args)

            def _send(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = render_prometheus(
                        obs.histograms, obs.store, obs.health,
                        alerts=obs.alerts,
                    ).encode()
                    self._send(
                        200, body,
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/alerts":
                    if obs.alerts is None:
                        payload = {"flow": obs.health.flow, "rules": [],
                                   "firing": []}
                    else:
                        payload = obs.alerts.snapshot()
                    self._send(
                        200, json.dumps(payload, default=str).encode(),
                        "application/json",
                    )
                elif path == "/healthz":
                    self._send(
                        200,
                        json.dumps(obs.health.health()).encode(),
                        "application/json",
                    )
                elif path == "/readyz":
                    reasons = obs.health.readiness()
                    status = 200 if not reasons else 503
                    payload = {
                        "ready": not reasons,
                        "reasons": reasons,
                        **obs.health.health(),
                    }
                    self._send(
                        status, json.dumps(payload).encode(),
                        "application/json",
                    )
                elif path == "/profile":
                    # capture state for pollers (POST starts one)
                    if obs.profiler is None:
                        self._send(
                            501,
                            b'{"error": "profiler surface disabled"}',
                            "application/json",
                        )
                        return
                    payload = {
                        "available": obs.profiler.available,
                        "active": obs.profiler.active(),
                        "captures": obs.profiler.captures_count,
                    }
                    self._send(
                        200, json.dumps(payload).encode(),
                        "application/json",
                    )
                else:
                    self._send(
                        404, b'{"error": "not found"}', "application/json"
                    )

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path != "/profile":
                    self._send(
                        404, b'{"error": "not found"}', "application/json"
                    )
                    return
                if obs.profiler is None or not obs.profiler.available:
                    self._send(
                        501,
                        json.dumps({
                            "error": "torch.profiler unavailable "
                                     "(surface disabled or a torch "
                                     "without profiler support)",
                        }).encode(),
                        "application/json",
                    )
                    return
                seconds = None
                for part in query.split("&"):
                    k, _, v = part.partition("=")
                    if k == "seconds":
                        try:
                            seconds = float(v)
                        except ValueError:
                            pass
                from .profiler import DEFAULT_SECONDS

                result = obs.profiler.start(
                    seconds if seconds is not None else DEFAULT_SECONDS
                )
                status = 200 if "error" not in result else 409
                self._send(
                    status, json.dumps(result).encode(), "application/json"
                )

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("observability endpoints on :%d", self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
