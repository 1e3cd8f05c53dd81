"""TimedScheduler: background timer driving batch-flow scheduling.

reference: DataX.Flow/DataX.Flow.Scheduler/TimedScheduler.cs:22+ — a
hosted service whose timer periodically calls the management service's
``flow/schedulebatch`` for batch-mode flows that are due. Recurrence
state (what ran last) lives with the scheduler; the per-round work —
regenerate configs for the next window, start jobs — is FlowOperation's
``schedule_batch``.

Schedule conf comes from the flow's gui ``batch`` entries:
``type`` = "oneTime" (run once, then disabled) or "recurring" with
``intervalSeconds``. Missing schedule info on a batching flow means
every scheduler tick is due (the reference's default daily recurrence
plays this role; a tick-gated default keeps one-box demos live).

Copy of the JAX package's ``serve/scheduler.py``, unchanged:
``PlacementReplanner`` re-plans through the port's
``FleetAdmissionGate`` (``serve/jobs.py``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class PlacementReplanner:
    """Re-plans fleet placement whenever jobs start or stop, so freed
    capacity is immediately reusable by the next admission check.

    The counterpart of ``serve/jobs.py``'s ``FleetAdmissionGate``:
    the gate decides *whether* a submit fits; this keeps the persisted
    flow->chip assignments (``JobRegistry`` records' ``placement``) and
    the ``Fleet_*``/``Placement_*`` metrics in step with the set of
    jobs actually running. ``JobOperation`` calls ``on_job_event`` after
    every successful start/stop AND after every in-place
    ``JobOperation.rescale`` (a replica-count change no longer needs a
    stop+start round trip — the rescale path re-runs admission through
    ``FleetAdmissionGate.admit_replicas`` before spawning, then lands
    here so the new replica set's placement persists); ``TimedScheduler``
    additionally calls it each tick so jobs that die on their own
    (crash, batch-mode completion) also release their modeled capacity.
    """

    def __init__(self, gate):
        self.gate = gate
        self.replans = 0

    def on_job_event(self):
        from ..obs import tracing

        # a child span of the active REST request trace when the
        # re-plan was caused by a traced start/stop; a no-op from the
        # scheduler's own tick thread
        with tracing.span("scheduler/replan"):
            report = self.gate.replan()
        self.replans += 1
        try:
            self.gate.metrics.send_metric(
                "Placement_Replans_Count", self.replans
            )
        except Exception:  # noqa: BLE001 — metrics must not fail ops
            logger.exception("placement metric export failed")
        return report


class TimedScheduler:
    def __init__(
        self,
        flow_ops,
        interval_s: float = 60.0,
        now_fn: Callable[[], float] = time.time,
        replanner: Optional[PlacementReplanner] = None,
        fleet_view=None,
    ):
        self.flow_ops = flow_ops
        self.interval_s = interval_s
        self.now = now_fn
        self.replanner = replanner
        # fleet telemetry plane: refresh the cross-replica rollup each
        # tick so /fleet/* routes and the Prometheus rollup serve from
        # a warm aggregate instead of paying the objstore list on read
        self.fleet_view = fleet_view
        # flow name -> batch index -> last run epoch (oneTime: ran at all)
        self._last_run: Dict[str, Dict[int, float]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rounds_triggered = 0

    # -- due computation --------------------------------------------------
    def due_flows(self) -> List[str]:
        """Batching flows with at least one due batch entry."""
        return [name for name, _ in self._due_work()]

    def _due_work(self) -> List[tuple]:
        """(flow name, due batch-entry indices) pairs, one store read."""
        out = []
        for doc in self.flow_ops.get_all_flows():
            gui = doc.get("gui") or {}
            if ((gui.get("input") or {}).get("mode")) != "batching":
                continue
            name = doc.get("name")
            entries = self._due_entries(name, gui)
            if entries:
                out.append((name, entries))
        return out

    def _due_entries(self, name: str, gui: dict) -> List[int]:
        entries = gui.get("batch") or [{}]
        ran = self._last_run.setdefault(name, {})
        now = self.now()
        out = []
        for i, b in enumerate(entries):
            props = (b.get("properties") or {}) if isinstance(b, dict) else {}
            btype = (props.get("type") or b.get("type") or "recurring") \
                if isinstance(b, dict) else "recurring"
            last = ran.get(i)
            if str(btype).lower() == "onetime":
                if last is None:
                    out.append(i)
            else:
                interval = float(
                    props.get("intervalSeconds")
                    or props.get("interval")
                    or self.interval_s
                )
                if last is None or now - last >= interval:
                    out.append(i)
        return out

    # -- tick -------------------------------------------------------------
    def tick(self) -> List[str]:
        """One scheduling pass; returns flows triggered this round."""
        triggered = []
        for name, entries in self._due_work():
            try:
                self.flow_ops.schedule_batch(name)
            except Exception as e:  # noqa: BLE001 — skip flow, keep ticking
                logger.warning("schedulebatch for %s failed: %s", name, e)
                continue
            now = self.now()
            for i in entries:
                self._last_run[name][i] = now
            self.rounds_triggered += 1
            triggered.append(name)
        if self.replanner is not None:
            # jobs that exited on their own since the last tick release
            # their modeled capacity here
            try:
                self.replanner.on_job_event()
            except Exception:  # noqa: BLE001 — scheduler must survive
                logger.exception("scheduled placement re-plan failed")
        if self.fleet_view is not None:
            try:
                self.fleet_view.refresh()
            except Exception:  # noqa: BLE001 — scheduler must survive
                logger.exception("fleet telemetry refresh failed")
        return triggered

    # -- background loop --------------------------------------------------
    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — scheduler must survive
                    logger.exception("scheduler tick failed")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
