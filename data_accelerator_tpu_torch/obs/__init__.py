"""Observability: metric store, metric logger, telemetry, tracing,
latency histograms, Prometheus/health exposition.

Copy of the JAX package's ``obs/__init__.py``; the modules it does not
name (alerts, conformance, calibration, the profiler, the fleet
publisher) are not ported yet."""

from .store import MetricStore, METRIC_STORE
from .metrics import MetricLogger
from .histogram import HISTOGRAMS, HistogramRegistry, LatencyHistogram
from .tracing import Tracer, current_trace, span
from .exposition import HealthState, ObservabilityServer, render_prometheus

__all__ = [
    "MetricStore",
    "METRIC_STORE",
    "MetricLogger",
    "HISTOGRAMS",
    "HistogramRegistry",
    "LatencyHistogram",
    "Tracer",
    "current_trace",
    "span",
    "HealthState",
    "ObservabilityServer",
    "render_prometheus",
]
