"""Observability: metric store, metric logger, telemetry, tracing,
latency histograms, Prometheus/health exposition.

Copy of the JAX package's ``obs/__init__.py``. The modules it does not
import (alerts, conformance, calibration, the profiler, the fleet
publisher and view, the ``obs`` CLI in ``__main__.py``) are imported
where they are used."""

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
