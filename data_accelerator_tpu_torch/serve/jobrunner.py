"""JobRunner: scheduled e2e scenario suites as a liveness probe.

reference: Services/JobRunner/{JobRunner.cs,Jobs/*.cs} — an Azure WebJob
that periodically executes scenario suites (deploy flow, schema
inference + interactive query) against a *live* deployment via its REST
API, recording pass/fail per run (Jobs/DataXDeployJob.cs:21-45) — the
production smoke monitor. Scenarios themselves come from the
ScenarioTester step framework (serve/scenario.py here).

Results are (a) kept as a bounded in-memory history for the UI/API and
(b) emitted as metric points ``DATAX-JobRunner:<scenario>`` (1 pass /
0 fail) into the metric store so the dashboard can chart liveness —
the role AppInsights plays for the reference's runner.

A copy of the JAX package's ``serve/jobrunner.py`` over the port's
``obs/metrics.py::MetricLogger``; nothing else changed.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs.metrics import MetricLogger
from .scenario import Scenario, ScenarioContext, ScenarioResult

logger = logging.getLogger(__name__)


class JobRunner:
    def __init__(
        self,
        scenarios: List[Scenario],
        interval_s: float = 300.0,
        metric_logger: Optional[MetricLogger] = None,
        context_factory: Optional[Callable[[], ScenarioContext]] = None,
        max_history: int = 200,
    ):
        self.scenarios = scenarios
        self.interval_s = interval_s
        self.metric_logger = metric_logger or MetricLogger("DATAX-JobRunner")
        self.context_factory = context_factory or ScenarioContext
        self.history: List[Dict] = []
        self.max_history = max_history
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> List[ScenarioResult]:
        """Execute every scenario once, recording results + metrics."""
        results = []
        for sc in self.scenarios:
            t0 = time.time()
            result = sc.run(self.context_factory())
            elapsed_ms = (time.time() - t0) * 1000.0
            uts = int(t0 * 1000)
            record = {
                "scenario": sc.name,
                "success": result.success,
                "failedStep": result.failed_step,
                "elapsedMs": elapsed_ms,
                "uts": uts,
            }
            self.history.append(record)
            del self.history[: max(0, len(self.history) - self.max_history)]
            self.metric_logger.send_metric(
                sc.name, 1 if result.success else 0, uts
            )
            self.metric_logger.send_metric(f"{sc.name}-ElapsedMs", elapsed_ms, uts)
            (logger.info if result.success else logger.warning)(
                "scenario %s: %s (%.0f ms)%s",
                sc.name,
                "PASS" if result.success else "FAIL",
                elapsed_ms,
                "" if result.success else f" at step {result.failed_step}",
            )
            results.append(result)
        return results

    def start(self) -> None:
        def loop():
            while not self._stop.is_set():
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 — the probe must survive
                    logger.exception("job runner round failed")
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
