"""Scenario runner: ordered steps over a live API, optionally N-way
parallel.

reference: Tests/ScenarioTester — ``[Step]``-attributed methods share a
``ScenarioContext`` and run in declaration order
(ScenarioTester/ScenarioTester/StepAttribute.cs, ScenarioDescription);
the runner executes a scenario N times in parallel and reports per-step
pass/fail. Used both by the e2e test suite (Tests/DataXScenarios) and
the production liveness prober (Services/JobRunner) — same split here:
tests and serve/jobrunner.py both drive this runner.

A copy of the JAX package's ``serve/scenario.py``: framework-free, with
nothing changed but this docstring.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class ScenarioContext(dict):
    """Shared state across a scenario's steps (ScenarioContext analog)."""


@dataclass
class StepResult:
    name: str
    success: bool
    elapsed_s: float
    error: Optional[str] = None


@dataclass
class ScenarioResult:
    name: str
    steps: List[StepResult] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return all(s.success for s in self.steps)

    @property
    def failed_step(self) -> Optional[str]:
        for s in self.steps:
            if not s.success:
                return s.name
        return None


@dataclass
class Scenario:
    """Named ordered steps; each step is ``fn(ctx) -> None`` and may
    read/write the shared context."""

    name: str
    steps: List[Callable] = field(default_factory=list)

    def step(self, fn: Callable) -> Callable:
        """Decorator registering a step in declaration order."""
        self.steps.append(fn)
        return fn

    def run(self, ctx: Optional[ScenarioContext] = None) -> ScenarioResult:
        """Run steps in order; a failing step aborts the rest
        (fail-fast like the reference runner)."""
        ctx = ctx if ctx is not None else ScenarioContext()
        result = ScenarioResult(self.name)
        for fn in self.steps:
            t0 = time.time()
            try:
                fn(ctx)
                result.steps.append(
                    StepResult(fn.__name__, True, time.time() - t0)
                )
            except Exception:  # noqa: BLE001 — recorded per step
                result.steps.append(StepResult(
                    fn.__name__, False, time.time() - t0,
                    error=traceback.format_exc(limit=5),
                ))
                break
        return result

    def run_parallel(
        self, n: int, make_ctx: Optional[Callable[[int], ScenarioContext]] = None
    ) -> List[ScenarioResult]:
        """N concurrent executions (the runner's parallel mode)."""
        results: Dict[int, ScenarioResult] = {}
        lock = threading.Lock()

        def run_one(i: int) -> None:
            ctx = make_ctx(i) if make_ctx else ScenarioContext({"execution": i})
            r = self.run(ctx)
            with lock:
                results[i] = r

        threads = [
            threading.Thread(target=run_one, args=(i,)) for i in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return [results[i] for i in range(n)]
