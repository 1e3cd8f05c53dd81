"""StreamingHost: the micro-batch driver loop of the PyTorch port.

reference: datax-host host/StreamingHost.scala:22-97 — build config,
create the processor, wire the input stream, then per batch: process,
emit metrics, checkpoint offsets every checkpointInterval; per-batch
failures log + rethrow so the batch retries (at-least-once,
CommonProcessorFactory.scala:382-398).

The port of the JAX package's ``runtime/host.py``: the same loops
(``run``, ``run_batch``, ``run_pipelined``), the same ordering and
recovery invariants, the same metrics, checkpoints and pilot, over the
port's ``FlowProcessor`` on a CUDA card (``device="cuda"``, the default,
which raises without one) or on the CPU when the caller asks for it.

As in the JAX host: the boot conf audit (``runtime/confaudit.py``:
``Conf_*`` gauges, DX1006 events), the conformance monitor
(``obs/conformance.py``, DX501-503, DX520/521 and DX522) and the alert
rules (``obs/alerts.py``: evaluated after each batch's store flush,
served on ``GET /alerts`` and ``datax_alert_firing``, and voted into the
pilot). One source per ``input.sources.*`` entry: each batch polls,
decodes, acks and checkpoints every source. The observability plane
(slice 6): machine-profile calibration of the host's device at init
(``obs/calibrate.py``, ``observability.calibration``/``calibrationfile``/
``calibrationurl``), whose ``Calib_*`` gauges ride every batch and whose
profile prices the conf's cost model into the DX520/521 predictions; the
on-demand ``torch.profiler`` capture behind ``POST /profile``
(``obs/profiler.py``, ``observability.profiler``/``profilerdir``); fleet
telemetry frames (``obs/publisher.py``, ``process.fleet.publishurl``);
and the delivery-protocol monitor (``runtime/protocolmonitor.py``,
``process.debug.protocolmonitor``, runtime DX906). With
``process.debug.buffersanitizer`` the host flight-records the
sanitizer's DX805 events (``sanitizer/poison``) and checks every window
checkpoint for aliasing and sentinel residue before it is saved.

A conf's ``process.numchips`` runs the flow over a mesh
(``dist/mesh.py``), clamped to the visible cards; ``mesh=`` hands the
host a mesh of its own (virtual shards of one card or of the CPU, the
counterpart of the JAX package's virtual devices). Under a mesh the
landing runs inline (background transfer off), as in the JAX package,
and each batch's collective census (``Mesh_ICI_Bytes``,
``Mesh_Reshard_Count``) reaches the conformance monitor, which holds it
against the conf's sharding model (``process.mesh.model``, DX510/511).

CUDA state is per thread in PyTorch: the current device and stream.
The decode-ahead worker (which copies ``LocalSource`` columns to the
card) and the landing worker enter the processor's device and the
host's stream when they start, and the loops run their dispatches on
that same stream, so a step is ordered after the copies of its input.

Run one-box:
    python -m data_accelerator_tpu_torch.runtime.host conf=<flow>.conf batches=10
    python -m data_accelerator_tpu_torch.runtime.host conf=<flow>.conf batches=3 device=cpu
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from ..constants import MetricName
from ..core.config import SettingDictionary, SettingNamespace
from ..core.confmanager import ConfigManager
from ..dist.mesh import Mesh
from ..obs import telemetry, tracing
from ..obs.alerts import AlertEngine
from ..obs.calibrate import get_profile
from ..obs.conformance import ConformanceMonitor
from ..obs.exposition import HealthState, ObservabilityServer
from ..obs.histogram import HISTOGRAMS
from ..obs.metrics import MetricLogger
from ..obs.profiler import ProfilerSurface
from ..obs.publisher import TelemetryFramePublisher
from ..obs.tracing import Tracer
from ..pilot.controller import PilotController
from . import confaudit, protocolmonitor
from .checkpoint import OffsetCheckpointer, WindowStateCheckpointer
from .processor import FlowProcessor, record_device_step
from .sinks import OutputDispatcher, build_output_operators
from .sources import LocalSource, StreamingSource, make_source

logger = logging.getLogger(__name__)


def _enter_stream(stream: Optional["torch.cuda.Stream"]) -> None:
    """Make ``stream`` and its card current on the calling thread for
    good (a worker thread's initializer; nothing on the CPU). It takes
    the stream, not the host, so a worker thread that outlives its
    host's stop keeps no reference to the host."""
    if stream is not None:
        torch.cuda.set_device(stream.device)
        torch.cuda.set_stream(stream)


class StreamingHost:
    def __init__(
        self,
        dict_: SettingDictionary,
        source: Optional[StreamingSource] = None,
        udfs: Optional[dict] = None,
        table_sink_map: Optional[Dict[str, list]] = None,
        device: "torch.device | str" = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.dict = dict_
        self.processor = FlowProcessor(dict_, udfs=udfs, device=device, mesh=mesh)
        self.device = self.processor.device
        # the stream every step of this host runs on; the workers enter
        # it too (see _on_card)
        self._stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )
        self.metric_logger = MetricLogger.from_conf(dict_)
        # lifecycle telemetry (AppInsightLogger analog): batch begin/end
        # events + exceptions with app context (AppInsightLogger.scala:18-108)
        self.telemetry = telemetry.from_conf(dict_)
        # batch-granular span tracing + per-stage latency histograms:
        # every stage boundary of every micro-batch is a span in the
        # telemetry fan-out and a sample in the stage's live latency
        # distribution (conf process.telemetry.tracing, default on;
        # `telemetry.parenttrace=<trace>:<span>` joins a parent trace)
        tele_conf0 = dict_.get_sub_dictionary("datax.job.process.telemetry.")
        self.tracer = Tracer(
            self.telemetry,
            histograms=HISTOGRAMS,
            flow=dict_.get_job_name(),
            enabled=(
                tele_conf0.get_or_else("tracing", "true") or ""
            ).lower() != "false",
            parent=tele_conf0.get("parenttrace"),
        )
        # model-vs-observed conformance: config generation embeds the
        # cost-model report (process.conformance.model); the monitor
        # compares windowed observations against it and emits
        # Conformance_* gauges + DX5xx drift events
        self.conformance = ConformanceMonitor.from_conf(
            dict_, flow=dict_.get_job_name()
        )
        # process.debug.protocolmonitor arms the dynamic half of the
        # DX9xx exactly-once defense: the batch tail records its actual
        # protocol-event sequence and every sealed batch's linearization
        # is validated against the declared spec; violations fire
        # runtime DX906
        self.protocol_monitor = protocolmonitor.from_conf(
            dict_.get_sub_dictionary(SettingNamespace.JobProcessPrefix + "debug.")
        )
        # boot-time conf audit: the conf this host started with, replayed
        # through the DX10xx lattice validator; unknown/out-of-bounds keys
        # flight-record DX1006 (conf/violation events + Conf_* gauges).
        # Advisory: never blocks boot.
        self.conf_audit = confaudit.from_conf(
            dict_,
            subject="host",
            telemetry=self.telemetry,
            metric_logger=self.metric_logger,
        )

        input_conf = dict_.get_sub_dictionary(SettingNamespace.JobInputPrefix)
        # one StreamingSource per declared input source; the injected
        # ``source`` binds to the primary
        self.sources: Dict[str, StreamingSource] = {}
        for name, spec in self.processor.specs.items():
            if name == self.processor.primary and source is not None:
                self.sources[name] = source
            else:
                self.sources[name] = make_source(
                    spec.conf, spec.schema, source=name
                )
        self.source = self.sources[self.processor.primary]
        self.interval_s = self.processor.interval_s
        self.max_rate = int(input_conf.get_or_else("eventhub.maxrate", "1000"))
        # backpressure: when a batch overruns the interval, shrink the
        # next poll; recover multiplicatively when batches are fast
        # (the effective rate adapts between maxrate/8 and maxrate)
        self._rate_scale = 1.0

        # offset checkpointing (EventhubCheckpointer semantics)
        ckpt_dir = input_conf.get("eventhub.checkpointdir") or input_conf.get(
            "streaming.checkpointdir"
        )
        self.checkpointer = (
            OffsetCheckpointer(ckpt_dir) if ckpt_dir else None
        )
        # window-state checkpointing: the offsets file only replays the
        # last batch; ring buffers hold up to window+watermark of
        # history that a restart would silently zero. Persist them on
        # the same cadence and restore on start.
        self.window_checkpointer = (
            WindowStateCheckpointer(ckpt_dir)
            if ckpt_dir and self.processor.window_buffers
            else None
        )
        self.checkpoint_interval_s = (
            input_conf.get_duration_option("eventhub.checkpointinterval") or 60.0
        )
        self._last_checkpoint = 0.0

        # health/readiness state + the Prometheus/health HTTP surface
        # (/metrics, /healthz, /readyz), served when
        # process.observability.port is set (0 = ephemeral port)
        obs_conf = dict_.get_sub_dictionary(
            SettingNamespace.JobProcessPrefix + "observability."
        )
        self.health = HealthState(
            flow=dict_.get_job_name(),
            checkpoint_interval_s=(
                self.checkpoint_interval_s if self.checkpointer else None
            ),
            batch_interval_s=self.interval_s,
            stall_fail_ms=obs_conf.get_double_option("stallfailms"),
            stall_ewma_half_life_ms=obs_conf.get_double_option("stallewmams"),
        )
        # declarative alert rules from the generated conf
        # (process.alerts.rules): evaluated every batch finish and on
        # every /alerts and /metrics request over the same
        # store/histogram/health surfaces the dashboards read
        self.alerts = AlertEngine.from_conf(
            dict_,
            flow=dict_.get_job_name(),
            store=self.metric_logger.store,
            histograms=HISTOGRAMS,
            health=self.health,
        )
        # fleet telemetry plane: when process.fleet.publishurl is conf'd,
        # every batch finish folds into a windowed frame shipped to the
        # shared objstore for the control plane's FleetView rollup.
        # None = per-process only.
        self.fleet_publisher = TelemetryFramePublisher.from_conf(
            dict_,
            flow=dict_.get_job_name(),
            metric_logger=self.metric_logger,
            histograms=HISTOGRAMS,
        )
        # machine-profile calibration of this host's device: torch
        # micro-probes, cached per process and device and persisted/
        # shared through observability.calibrationfile / calibrationurl.
        # The profile prices the conf-embedded byte+FLOP model into the
        # DX520/DX521 roofline predictions and exports as the Calib_*
        # series on every batch. Off with observability.calibration=false
        # (the monitor's latency checks then stay disarmed unless
        # conformance.latency pins them).
        self._calib_metrics: Dict[str, float] = {}
        if (obs_conf.get_or_else("calibration", "true") or "").lower() \
                != "false":
            try:
                profile = get_profile(
                    cache_file=obs_conf.get("calibrationfile"),
                    share_url=obs_conf.get("calibrationurl"),
                    device=self.device,
                )
                self._calib_metrics = profile.metrics()
                if self.conformance is not None \
                        and not self.conformance.latency_pinned:
                    # the eager step pays a dispatch overhead a kernel
                    preds, compute_ms, overhead_ms = (
                        self.conformance.model.latency_predictions(
                            profile.to_dict(),
                            launches=self.launches_per_step(),
                        )
                    )
                    self.conformance.set_latency(
                        preds, compute_ms, overhead_ms
                    )
            except Exception:  # noqa: BLE001 — calibration is optional
                logger.exception(
                    "machine-profile calibration failed; "
                    "DX52x latency checks disarmed"
                )
        # live device-memory watermark sampling (observability.hbmsample,
        # default on): Hbm_BytesInUse/Hbm_PeakBytes each batch, absent
        # on the CPU, which reports no allocator stats
        self.hbm_sample = (
            (obs_conf.get_or_else("hbmsample", "true") or "").lower()
            != "false"
        )

        # on-demand profiler surface: POST /profile?seconds=N on the
        # observability port arms a torch.profiler capture that lands
        # beside the flight recorder (observability.profilerdir
        # overrides). Off with observability.profiler=false.
        self.profiler: Optional[ProfilerSurface] = None
        if (obs_conf.get_or_else("profiler", "true") or "").lower() \
                != "false":
            prof_dir = obs_conf.get("profilerdir")
            if not prof_dir:
                tracefile = tele_conf0.get("tracefile")
                base = (
                    os.path.dirname(os.path.abspath(tracefile))
                    if tracefile else tempfile.gettempdir()
                )
                prof_dir = os.path.join(
                    base, f"profiler-{dict_.get_job_name() or 'flow'}"
                )
            self.profiler = ProfilerSurface(
                prof_dir, flow=dict_.get_job_name(),
                cuda=self.device.type == "cuda",
            )

        self.obs_server: Optional[ObservabilityServer] = None
        obs_port = obs_conf.get_int_option("port")
        if obs_port is not None:
            self.obs_server = ObservabilityServer(
                self.health,
                histograms=HISTOGRAMS,
                store=self.metric_logger.store,
                port=obs_port,
                alerts=self.alerts,
                profiler=self.profiler,
            )
            self.obs_server.start()

        if self.checkpointer:
            positions = self.checkpointer.starting_positions()
            for s in self.sources.values():
                s.start(positions)
        # window restore, local first: a plain restart reloads its own
        # window.npz; a RESCALE SUCCESSOR (fresh dirs, objstore mirror
        # configured) pulls only the window partitions its replica
        # index owns and merges them — the handoff path
        self.window_restored_from: Optional[str] = None
        if self.window_checkpointer:
            snap = self.window_checkpointer.load()
            if snap is not None:
                if self.processor.restore_window_state(snap):
                    self.window_restored_from = "local"
                    logger.info("restored window state from checkpoint")
                else:
                    logger.warning(
                        "window-state checkpoint incompatible with current "
                        "flow config; starting with empty windows"
                    )
        if (
            self.window_restored_from is None
            and self.processor.window_buffers
            and self.processor.state_mirror is not None
        ):
            try:
                if self.processor.restore_window_partitions():
                    self.window_restored_from = "partitions"
                    logger.info(
                        "restored window state from %d assigned partitions",
                        len(self.processor.state_owned),
                    )
            except Exception:  # noqa: BLE001 — empty windows beat a dead init
                logger.exception(
                    "window partition handoff failed; starting empty"
                )
        self._drain_state_events()

        # sink routing: dataset -> output names; default: each conf output
        # name routes its same-named dataset (S500 contract)
        if table_sink_map is None:
            conf_outputs = dict_.get_sub_dictionary(
                SettingNamespace.JobOutputPrefix
            ).group_by_sub_namespace()
            table_sink_map = {name: [name] for name in conf_outputs}
        operators = build_output_operators(dict_, self.metric_logger, table_sink_map)
        self.dispatcher = OutputDispatcher(operators, self.metric_logger)
        with self.processor.compile_scope():
            self.dispatcher.prepare()

        self.batches_processed = 0
        self._stop = False

        # background result landing: in the pipelined loop the only
        # BLOCKING device read per batch is the counts vector; the
        # batch tail (collect_landed -> sinks -> commit -> ack ->
        # metrics -> checkpoint) runs on this one-thread landing
        # executor, so landings stay strictly FIFO while the dispatch
        # loop keeps feeding the device. Conf
        # datax.job.process.pipeline.backgroundtransfer (default on);
        # off under a mesh like sized transfer.
        pipe_conf = dict_.get_sub_dictionary(
            SettingNamespace.JobProcessPrefix + "pipeline."
        )
        self.background_transfer = (
            (pipe_conf.get_or_else("backgroundtransfer", "true") or "")
            .lower() != "false"
        ) and self.processor.mesh is None
        self._landing_pool = (
            ThreadPoolExecutor(
                1, thread_name_prefix="landing",
                initializer=functools.partial(_enter_stream, self._stream),
            )
            if self.background_transfer else None
        )
        self._landings = deque()  # futures of submitted landings, FIFO
        self._landing_failed: Optional[BaseException] = None

        # live pipeline depth: starts at the conf'd depth; the pilot's
        # DepthActuator retargets it (request_depth) and run_pipelined
        # applies the change at a window boundary by draining the
        # in-flight FIFO down to the new depth first
        self._live_depth = max(1, self.processor.pipeline_depth)
        self._depth_target: Optional[int] = None

        # the autopilot (pilot/controller.py, conf
        # datax.job.process.pilot.*, default on): once per evaluation
        # window it maps the stall EWMA, landing backlog, poll
        # saturation and malformed rate to bounded actuations (pipeline
        # depth, source admission) through typed actuators
        self.pilot = PilotController.from_conf(dict_, host=self)

    def _drain_state_events(self) -> None:
        """Flight-record the DX53x events the state loaders queued
        (DX530 active-side fallback, DX531 both-sides-bad -> empty):
        typed events beside conformance drift, so a corrupted snapshot
        handoff is visible in the trace output and the recorder. The
        list is emptied in place: every state table appends to it."""
        events = list(self.processor.state_events)
        del self.processor.state_events[:len(events)]
        for ev in events:
            try:
                self.telemetry.track_event("state/fallback", dict(ev))
            except Exception:  # noqa: BLE001 — telemetry never fails state
                logger.exception("state event emit failed")

    # -- per-thread CUDA state --------------------------------------------
    @contextlib.contextmanager
    def _on_card(self):
        """The processor's card and the host's stream, current on the
        calling thread while a loop runs on it."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self._stream.device), torch.cuda.stream(self._stream):
            yield

    # -- pilot actuation surface ------------------------------------------
    def live_depth(self) -> int:
        """The commanded pipeline depth: the pending pilot target when
        one exists, else the depth the dispatch loop is running."""
        return (
            self._depth_target if self._depth_target is not None
            else self._live_depth
        )

    def request_depth(self, depth: int) -> None:
        """Ask the dispatch loop to resize the in-flight window; the
        change applies at the next loop iteration, draining the window
        down to the new depth first (FIFO) when shrinking."""
        self._depth_target = max(1, int(depth))

    def _current_depth(self, depth: int) -> int:
        """Apply a pending pilot depth retarget (loop thread only)."""
        if self._depth_target is not None and self._depth_target != depth:
            logger.info(
                "pilot depth change: %d -> %d", depth, self._depth_target
            )
            depth = self._depth_target
        self._depth_target = None
        self._live_depth = depth
        return depth

    # -- loop -------------------------------------------------------------
    def _poll_and_encode(self):
        """Poll every source and encode one batch per source; returns
        (raw dict, consumed offsets, batch_time_ms, t0)."""
        t0 = time.time()
        batch_time_ms = int(t0 * 1000)
        raw: Dict[str, object] = {}
        consumed: Dict = {}
        for name, src in self.sources.items():
            spec = self.processor.specs[name]
            max_events = min(
                spec.capacity,
                max(1, int(self.max_rate * self.interval_s * self._rate_scale)),
            )
            if self.pilot is not None:
                # source backpressure: the pilot's token bucket is the
                # admission point
                max_events = max(1, self.pilot.admit_events(max_events))
            received = max_events
            malformed0 = self.processor.malformed_rows_total
            if isinstance(src, LocalSource):
                cols, now_ms, c = src.poll_columns(
                    max_events, self.processor.dictionary
                )
                # on CUDA the columns' copies queue on this thread's
                # current stream, the host's, ahead of the step
                raw[name] = self.processor.encode_columns(
                    cols, max_events, source=name
                )
                if len(self.sources) == 1:
                    # the generator's clock IS the batch time
                    batch_time_ms = now_ms
            elif hasattr(src, "poll_raw"):
                # native ingest: raw wire bytes -> C++ decoder into the
                # pooled host matrix (to_device=False); the dispatch
                # makes its one host-to-device copy
                blob, _n, c = self._poll_raw_traced(src, max_events)
                received = _n
                raw[name] = self.processor.encode_json_bytes(
                    blob, (batch_time_ms // 1000) * 1000, source=name,
                    to_device=False,
                    fmt=getattr(src, "raw_format", "jsonl"),
                )
            else:
                rows, c = src.poll(max_events)
                received = len(rows)
                raw[name] = self.processor.encode_rows(
                    rows, (batch_time_ms // 1000) * 1000, source=name
                )
            # source-side ingest counters (KafkaSource's malformed
            # values, the wire client's CRC-skipped corrupt batches)
            # merge into the processor's ingest counters
            take = getattr(src, "take_ingest_stats", None)
            if take is not None:
                for k, v in take().items():
                    self.processor._count_ingest(
                        k, v, malformed=k == "malformed_rows"
                    )
            if self.pilot is not None:
                # saturation + malformed-rate signals for the window
                self.pilot.observe_poll(
                    max_events, received,
                    self.processor.malformed_rows_total - malformed0,
                )
            consumed.update(c)
        return raw, consumed, batch_time_ms, t0

    @staticmethod
    def _poll_raw_traced(src, max_events: int):
        """``src.poll_raw`` under a ``poll`` span (the drain and join of
        the buffered lines), and the wait of the batch's oldest event
        inside the program as ``source/wait``: from its arrival stamp to
        the drain, where the source keeps both (``last_poll``)."""
        with tracing.span("poll") as props:
            blob, n, offsets = src.poll_raw(max_events)
            props["lines"] = n
            last = getattr(src, "last_poll", None)
            if last is not None:
                props["buffered"] = last["buffered"]
                props["reader_cpu_ms"] = round(last["reader_cpu_ms"], 3)
        trace = tracing.current_trace()
        if trace is not None and last is not None and last["arrival"] is not None:
            trace.record(
                "source/wait", last["arrival"],
                (last["polled"] - last["arrival"]) * 1000.0,
            )
        return blob, n, offsets

    def _finish(
        self, handle, consumed, batch_time_ms, t0, trace,
        inflight_depth: int = 1,
        background: bool = False,
    ) -> Optional[Dict[str, float]]:
        """Finish a batch. The calling thread pays only the counts-only
        sync (``collect_counts``); the tail (collect tables -> sinks ->
        commit -> ack -> metrics -> checkpoint) runs inline, or with
        ``background`` on the landing thread. Failures requeue un-acked
        source batches and rethrow so the batch retries, at-least-once;
        a background landing failure is recorded and re-raised on the
        dispatch loop, which then requeues the whole window. Returns the
        batch metrics inline, or None when the tail went to the landing
        thread."""
        stall_ms = 0.0
        try:
            with trace.activate(), tracing.span("sync"):
                sync_t0 = time.time()
                handle.collect_counts()
                # time the dispatch loop stalled waiting for the
                # window's oldest batch to leave the device
                stall_ms = (time.time() - sync_t0) * 1000.0
            record_device_step(handle, trace)
        except Exception as e:
            self.telemetry.track_exception(
                e, {"event": "error/streaming/process", "batchTime": batch_time_ms}
            )
            self.health.record_batch(
                batch_time_ms, ok=False, error=f"{type(e).__name__}: {e}"
            )
            trace.end(status="error")
            handle.abandon()
            if background:
                # let already-queued (earlier, independent) landings ack
                # before the requeue, so the un-acked FIFO can't race
                self._settle_landings()
            for s in self.sources.values():
                s.requeue_unacked()
            logger.exception("batch sync failed; rethrowing for retry")
            raise
        if background and self._landing_pool is not None:
            backlog = self._prune_landings()
            self._landings.append(self._landing_pool.submit(
                self._landing_run, handle, consumed, batch_time_ms, t0,
                trace, inflight_depth, stall_ms, backlog,
            ))
            return None
        return self._finish_tail(
            handle, consumed, batch_time_ms, t0, trace, inflight_depth,
            stall_ms, None, requeue_on_error=True,
        )

    def _landing_run(
        self, handle, consumed, batch_time_ms, t0, trace,
        inflight_depth, stall_ms, backlog,
    ) -> Optional[Dict[str, float]]:
        """One queued landing on the background thread. After a recorded
        failure the rest of the queue drains as no-ops — later batches
        stay un-acked, and the dispatch loop requeues the whole
        window."""
        if self._landing_failed is not None:
            handle.abandon()
            trace.end(status="aborted")
            return None
        try:
            return self._finish_tail(
                handle, consumed, batch_time_ms, t0, trace, inflight_depth,
                stall_ms, backlog, requeue_on_error=False,
            )
        except Exception as e:  # noqa: BLE001 — re-raised on the loop thread
            self._landing_failed = e
            handle.abandon()
            return None

    def _prune_landings(self) -> int:
        """Drop completed landings from the FIFO; returns the number
        still pending (the background-transfer backlog gauge)."""
        while self._landings and self._landings[0].done():
            self._landings.popleft()
        return len(self._landings)

    def _wait_landing_backlog(self, depth: int) -> None:
        """Backpressure: never let pending landings outgrow the
        pipeline window — a landing thread that can't keep up must
        stall the dispatch loop, not grow an unbounded queue."""
        while self._prune_landings() > depth and self._landing_failed is None:
            try:
                self._landings[0].result(timeout=60)
            except Exception:  # noqa: BLE001 — failures surface via the flag
                pass

    def _check_landing_failure(self) -> None:
        if self._landing_failed is not None:
            raise self._landing_failed

    def _drain_landings(self) -> None:
        """Wait out every queued landing (FIFO), then surface any
        recorded failure on the calling thread."""
        while self._landings:
            self._landings.popleft().result()
        self._check_landing_failure()

    def _settle_landings(self) -> None:
        """Cleanup path: wait for queued landings without raising."""
        while self._landings:
            try:
                self._landings.popleft().result(timeout=60)
            except Exception:  # noqa: BLE001 — cleanup must not mask the cause
                pass

    def _finish_tail(
        self, handle, consumed, batch_time_ms, t0, trace,
        inflight_depth, stall_ms, backlog,
        requeue_on_error: bool = True,
    ) -> Dict[str, float]:
        """The batch tail behind the counts sync: land the streamed
        tables, run sinks, commit state, ack sources, then (the ``tail``
        span) emit metrics and checkpoint."""
        pm = self.protocol_monitor
        try:
            with trace.activate():
                land_t0 = time.time()
                with tracing.span("collect"):
                    datasets, metrics = handle.collect_landed()
                land_ms = (time.time() - land_t0) * 1000.0
                with tracing.span("sinks"):
                    self.dispatcher.dispatch(datasets, batch_time_ms)
                if pm is not None:
                    pm.record("SINK_EMIT", detail="dispatcher.dispatch")
                self.processor.commit()
                if pm is not None:
                    pm.record("POINTER_FLIP", detail="processor.commit")
                for name, s in self.sources.items():
                    s.ack()
                    if pm is not None:
                        pm.record("FIFO_ACK", source=name)
        except Exception as e:
            self.telemetry.track_exception(
                e, {"event": "error/streaming/process", "batchTime": batch_time_ms}
            )
            self.health.record_batch(
                batch_time_ms, ok=False, error=f"{type(e).__name__}: {e}"
            )
            trace.end(status="error")
            if requeue_on_error:
                for name, s in self.sources.items():
                    s.requeue_unacked()
                    if pm is not None:
                        pm.record("REQUEUE", source=name)
            if pm is not None:
                pm.seal_batch(batch_time_ms, failed=True)
            logger.exception("batch processing failed; rethrowing for retry")
            raise

        # the tail after the ack, up to the root's end: metrics, alerts,
        # the fleet publisher, the log line and the checkpoint
        with trace.activate(), tracing.span("tail"):
            metrics["Latency-Batch"] = (time.time() - t0) * 1000.0
            metrics["IngestRateScale"] = self._rate_scale
            metrics["Pipeline_Depth"] = float(inflight_depth)
            metrics["Pipeline_Stall_Ms"] = stall_ms
            if backlog is not None:
                # background landing accounting: landings still queued when
                # this one was submitted, and the ms this batch's streamed
                # tables took to resolve on the landing thread
                metrics["Transfer_Background_Pending"] = float(backlog)
                metrics["Transfer_Background_LandMs"] = land_ms
            self.health.record_stall(stall_ms)
            # the calibrated machine profile rides every batch as Calib_*
            # gauges (constant per process and device)
            metrics.update(self._calib_metrics)
            # live device-memory watermark: the caching allocator's
            # in-use/peak bytes, absent on the CPU
            if self.hbm_sample:
                hbm = self.processor.device_memory_stats()
                if hbm is not None:
                    metrics["Hbm_BytesInUse"] = float(hbm["bytes_in_use"])
                    metrics["Hbm_PeakBytes"] = float(hbm["peak_bytes_in_use"])
            # per-stage latency percentiles from the live histograms — the
            # DATAX-<flow>:Latency-<Stage>-pNN series
            for stage in MetricName.STAGES:
                stem = MetricName.stage_metric(stage)
                for q in (50, 95, 99):
                    v = HISTOGRAMS.percentile(self.health.flow, stage, q)
                    if v is not None:
                        metrics[f"{stem}-p{q}"] = v
            # model-vs-observed conformance: ratio gauges join this batch's
            # metrics; drift transitions become typed flight-recorder events
            # and store rows
            if self.conformance is not None:
                gauges, drift_events = self.conformance.observe(
                    metrics, batch_time_ms
                )
                metrics.update(gauges)
                for ev in drift_events:
                    props = ev.to_props()
                    self.telemetry.track_event("conformance/drift", props)
                    self.metric_logger.send_metric_events(
                        "Conformance_Drift", [props], batch_time_ms
                    )
                    logger.warning(
                        "conformance drift %s: %s", ev.code, ev.message
                    )
            # finished profiler captures stitch into THIS batch's trace as
            # span events (the capture path is then one `obs trace` away
            # from the batches it overlapped) and bump the capture counter
            if self.profiler is not None:
                for cap in self.profiler.drain_finished():
                    trace.record(
                        "profiler/capture", cap["startedTs"],
                        cap.get("durationMs") or 0.0, path=cap["path"],
                    )
                if self.profiler.captures_count:
                    metrics["Profiler_Captures_Count"] = float(
                        self.profiler.captures_count
                    )
            if pm is not None:
                # Protocol_Events_Count for this batch's recorded prefix
                # (the post-ack checkpoint trio drains on the next batch)
                metrics.update(pm.drain_metric_deltas())
            self.telemetry.batch_end(
                batch_time_ms, {"latencyMs": metrics["Latency-Batch"]}
            )
            self.metric_logger.send_batch_metrics(metrics, batch_time_ms)
            # alert evaluation AFTER the store flush so window aggregates
            # include this batch; the firing set rides the health payload
            # (readyz) and the Alerts_Firing series
            firing: List[dict] = []
            if self.alerts is not None:
                firing = self.alerts.evaluate()
                self.health.record_alerts(firing)
                self.metric_logger.send_metric(
                    "Alerts_Firing", float(len(firing)), batch_time_ms
                )
            # fleet telemetry frame accumulation: the acked batch's metric
            # deltas + consumed offset ranges fold into the open window;
            # record_batch is fail-open and thread-safe (this tail may run
            # on the landing thread)
            if self.fleet_publisher is not None:
                self.fleet_publisher.record_batch(
                    metrics, consumed, batch_time_ms,
                    health=self.health.health(), alerts=firing,
                )
            logger.info(
                "batch %d: %s",
                self.batches_processed + 1,
                " ".join(f"{k}={v:.1f}" for k, v in sorted(metrics.items())),
            )
            # DX53x state events (load fallback / both-sides-bad) land in
            # the flight recorder like conformance drift — typed, greppable
            self._drain_state_events()
            # runtime DX805: buffer-sanitizer poison hits join the recorder
            # the same way (and the Sanitizer_PoisonHit metric event stream)
            san = self.processor.buffer_sanitizer
            if san is not None:
                for ev in san.drain_events():
                    try:
                        self.telemetry.track_event("sanitizer/poison", ev)
                        self.metric_logger.send_metric_events(
                            "Sanitizer_PoisonHit", [ev], batch_time_ms
                        )
                    except Exception:  # noqa: BLE001 — telemetry never kills a batch
                        logger.exception("sanitizer event emit failed")
                    logger.warning("buffer sanitizer %s", ev.get("message"))
            # runtime DX906: protocol-monitor ordering violations from
            # previously sealed batches join the recorder the same way
            if pm is not None:
                for ev in pm.drain_events():
                    try:
                        self.telemetry.track_event("protocol/violation", ev)
                        self.metric_logger.send_metric_events(
                            "Protocol_Violation", [ev], batch_time_ms
                        )
                    except Exception:  # noqa: BLE001 — telemetry never kills a batch
                        logger.exception("protocol event emit failed")
                    logger.warning("protocol monitor %s", ev.get("message"))
            # dx-proto: post-commit at-least-once replay cursor: the window snapshot
            # and the offset commit run AFTER the ack on purpose — a crash
            # between ack and checkpoint replays from the previous offsets
            # into rings that already hold the events (duplicates, never
            # loss)
            if self.checkpointer and (
                t0 - self._last_checkpoint >= self.checkpoint_interval_s
            ):
                with tracing.span("checkpoint"):
                    if self.window_checkpointer:
                        # snapshot BEFORE offsets: a crash between the two
                        # leaves old offsets + new rings (at-least-once
                        # duplicates); the reverse order would resume PAST
                        # events the restored rings never saw
                        snap = self.processor.snapshot_window_state()
                        # armed sanitizer: a checkpoint must be REAL copies;
                        # shared memory with the live rings (or an earlier
                        # snapshot) or sentinel residue is caught before the
                        # snapshot is ever persisted
                        san = self.processor.buffer_sanitizer
                        if san is not None:
                            san.check_snapshot(snap, self.processor.window_buffers)
                        self.window_checkpointer.save(snap)
                        if pm is not None:
                            pm.record(
                                "DURABLE_WRITE",
                                detail="window_checkpointer.save",
                            )
                        if self.processor.state_mirror is not None:
                            # ship the owned window partitions (A/B + pointer
                            # per partition) so a rescale successor can pull
                            # exactly its assigned range — fail-closed: a
                            # dead store fails the batch, which requeues
                            self.processor.push_window_partitions(snap)
                            if pm is not None:
                                pm.record(
                                    "STATE_PUSH",
                                    detail="push_window_partitions",
                                )
                    self.checkpointer.checkpoint_batch(consumed)
                    if pm is not None:
                        pm.record(
                            "OFFSET_COMMIT", detail="checkpoint_batch",
                        )
                self._last_checkpoint = t0
                self.health.record_checkpoint()
            if pm is not None:
                pm.seal_batch(batch_time_ms)
            self.batches_processed += 1
            self.health.record_batch(
                batch_time_ms, ok=True, latency_ms=metrics["Latency-Batch"]
            )
            self.health.record_watermark(batch_time_ms)
        trace.end()
        return metrics

    def _traced_poll(self, trace):
        """Poll + encode under the batch's trace (the pipelined loop
        runs this on the decode-ahead worker thread, so the span needs
        explicit activation there)."""
        with trace.activate(), tracing.span("decode"):
            return self._poll_and_encode()

    def _dispatch_traced(self, trace, raw, batch_time_ms):
        """Dispatch under the batch's trace, marking the dispatch-done
        instant the later device-step span measures from."""
        trace.add(batchTime=batch_time_ms)
        if self.fleet_publisher is not None:
            # replica identity on every batch root span: what lets
            # `obs trace --stitch` group a shared flight recorder's
            # spans into the flow's cross-replica lineage segments
            trace.add(replica=self.fleet_publisher.replica)
        self.telemetry.batch_begin(batch_time_ms)
        with trace.activate(), tracing.span("dispatch"):
            handle = self.processor.dispatch_batch(raw, batch_time_ms)
        trace.mark("dispatch-done")
        return handle

    def _start_batch(self):
        """Poll + encode + dispatch one batch; a failure anywhere here
        requeues the polled batch so a later batch's ack can't release
        it unprocessed."""
        trace = self.tracer.begin("streaming/batch")
        try:
            raw, consumed, batch_time_ms, t0 = self._traced_poll(trace)
            handle = self._dispatch_traced(trace, raw, batch_time_ms)
        except Exception as e:
            self.health.record_batch(
                None, ok=False, error=f"{type(e).__name__}: {e}"
            )
            trace.end(status="error")
            for s in self.sources.values():
                s.requeue_unacked()
            raise
        return handle, consumed, batch_time_ms, t0, trace

    def _update_backpressure(self, busy_ms: float) -> None:
        """Adaptive backpressure on the loop's *busy* time (work per
        batch, pacing sleep excluded): overrunning the interval halves
        the next poll (down to 1/8 rate); fast batches recover gently.
        The static maxRate limiter stays the ceiling
        (EventHubStreamingFactory.scala:43)."""
        if busy_ms > self.interval_s * 1000.0:
            self._rate_scale = max(0.125, self._rate_scale * 0.5)
        elif busy_ms < self.interval_s * 500.0:
            self._rate_scale = min(1.0, self._rate_scale * 1.25)

    def run_batch(self) -> Dict[str, float]:
        """One micro-batch: poll -> encode -> device step -> sinks ->
        metrics -> checkpoint."""
        with self._on_card():
            metrics = self._finish(*self._start_batch())
        # synchronous loop: the batch's own latency is the busy time
        self._update_backpressure(metrics["Latency-Batch"])
        if self.pilot is not None:
            self.pilot.tick(batch_time_ms=int(time.time() * 1000))
        return metrics

    def run(self, max_batches: Optional[int] = None) -> None:
        """Paced loop (streaming.intervalInSeconds cadence,
        StreamingHost.scala:66-67)."""
        try:
            while not self._stop:
                start = time.time()
                self.run_batch()
                if max_batches is not None and self.batches_processed >= max_batches:
                    break
                sleep = self.interval_s - (time.time() - start)
                if sleep > 0:
                    # a one-span trace of its own, outside every batch's
                    # root, so Latency-Batch and the batch stage keep
                    # their meaning
                    pace = self.tracer.begin(
                        "streaming/pace", plannedMs=round(sleep * 1000.0, 3)
                    )
                    time.sleep(sleep)
                    pace.end()
        finally:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        """Close any in-flight on-demand capture so its trace is written
        before the loop (or the process) goes away."""
        if self.profiler is not None:
            self.profiler.stop()

    def run_pipelined(
        self,
        max_batches: Optional[int] = None,
        depth: Optional[int] = None,
    ) -> None:
        """Unpaced loop with up to ``depth`` batches in flight (conf
        ``datax.job.process.pipeline.depth``, default 2): a decode-ahead
        worker thread polls + decodes batch N+1 (the C++ JSON decoder
        releases the GIL, so this genuinely overlaps) while this thread
        dispatches batch N to the device and — once the window is full —
        finishes the OLDEST in-flight batch (collect + sinks + commit +
        ack).

        Ordering/recovery invariants at every depth:
        - finish/commit is strictly FIFO (the window is a deque popped
          from the left, and background landings run on ONE worker in
          submission order), so acks and offset checkpoints happen in
          dispatch order;
        - each batch joins its source's un-acked FIFO at poll time and
          is acked (in order) only after its own sinks succeed; a
          failure anywhere — including on the landing thread, with
          background transfers still in flight — drains the landing
          queue and requeues EVERY un-acked batch in the window before
          rethrowing (at-least-once);
        - the decode-ahead poll never polls a batch the loop will not
          dispatch;
        - a UDF ``on_interval`` refresh mid-window is safe: every
          ``PendingBatch`` keeps the pipeline of the step that produced
          it.

        With ``process.pipeline.backgroundtransfer`` (default on) each
        finish blocks only on the counts vector; the streamed output
        tables land and sinks ack on the background landing thread,
        bounded to at most ``depth`` queued landings (backpressure)."""
        if depth is None:
            # resume from the COMMANDED depth: a pilot retarget from an
            # earlier run persists across loop restarts
            depth = self.live_depth()
        depth = max(1, depth)
        self._depth_target = None
        self._live_depth = depth
        background = self.background_transfer and self._landing_pool is not None
        # FIFO window of (PendingBatch, consumed, batch_time_ms, t0, trace)
        pending = deque()
        pool = ThreadPoolExecutor(
            1, initializer=functools.partial(_enter_stream, self._stream)
        )
        fut = None
        fut_trace = None  # the trace of the batch `fut` is decoding
        # batches started over the host's lifetime: landings may lag
        # batches_processed, so the loop counts dispatches itself
        started = self.batches_processed
        self._landing_failed = None

        def drain(f):
            """Wait out an in-flight poll so its delivery lands in the
            un-acked FIFO BEFORE any requeue."""
            if f is None:
                return
            try:
                f.result(timeout=60)
            except Exception:  # noqa: BLE001 — failed poll requeued below
                pass

        try:
            with self._on_card():
                while not self._stop:
                    # a failed background landing surfaces here: stop
                    # feeding the device and run the whole-window requeue
                    self._check_landing_failure()
                    if max_batches is not None and started >= max_batches:
                        break
                    iter_t0 = time.time()
                    if fut is None:
                        fut_trace = self.tracer.begin("streaming/batch")
                        fut = pool.submit(self._traced_poll, fut_trace)
                    raw, consumed, batch_time_ms, t0 = fut.result()
                    trace, fut, fut_trace = fut_trace, None, None
                    handle = self._dispatch_traced(trace, raw, batch_time_ms)
                    started += 1
                    # decode-ahead: the NEXT batch's poll starts now,
                    # overlapping this window's collects + sinks — but
                    # only if a next iteration will actually run
                    if not self._stop and (
                        max_batches is None or started < max_batches
                    ):
                        fut_trace = self.tracer.begin("streaming/batch")
                        fut = pool.submit(self._traced_poll, fut_trace)
                    pending.append((handle, consumed, batch_time_ms, t0, trace))
                    # a pilot depth retarget lands here, at the window
                    # boundary: shrinking drains the FIFO below
                    depth = self._current_depth(depth)
                    while len(pending) > depth:
                        # window full: retire the oldest batch (strict
                        # FIFO); in background mode this blocks only on
                        # the counts vector
                        self._finish(
                            *pending.popleft(), inflight_depth=len(pending) + 1,
                            background=background,
                        )
                        self._wait_landing_backlog(depth)
                    # backpressure on iteration time, not Latency-Batch:
                    # a pipelined batch's latency spans ~depth iterations
                    self._update_backpressure((time.time() - iter_t0) * 1000.0)
                    if self.pilot is not None:
                        self.pilot.tick(batch_time_ms=batch_time_ms)
                while pending and not self._stop:
                    self._check_landing_failure()
                    self._finish(
                        *pending.popleft(), inflight_depth=len(pending) + 1,
                        background=background,
                    )
                # all tails must land before the loop returns (or
                # reports the failure)
                self._drain_landings()
        except Exception:
            # settle the in-flight poll FIRST, then the landing queue
            # (queued landings after a failure no-op and leave their
            # batches un-acked), then requeue everything un-acked
            # across the whole window
            drain(fut)
            fut = None
            if fut_trace is not None:
                fut_trace.end(status="aborted")
            for item in pending:
                item[4].end(status="aborted")  # idempotent
                item[0].abandon()  # release transfer slots
            self._settle_landings()
            for s in self.sources.values():
                s.requeue_unacked()
            raise
        finally:
            drain(fut)
            if fut_trace is not None:
                fut_trace.end(status="aborted")  # idempotent
            pool.shutdown(wait=False, cancel_futures=True)
            self._stop_profiler()

    def launches_per_step(self) -> int:
        """The kernels one batch of this host's flow launches on a card
        (``deviceplan.count_step_launches`` on ``meta``)."""
        from ..analysis.deviceplan import (
            count_step_launches,
            flow_plan_from_processor,
        )

        return count_step_launches(flow_plan_from_processor(self.processor))

    def stop(self, close_sources: bool = True) -> None:
        """``close_sources=False`` tears the host down but leaves its
        sources open, for a successor host to take over the surviving
        source/checkpoint state the way a rescheduled job takes over its
        partitions."""
        self._stop = True
        self._stop_profiler()
        if self._landing_pool is not None:
            # let queued landings flush their sinks/acks before the
            # dispatcher and sources close underneath them
            self._settle_landings()
            self._landing_pool.shutdown(wait=True)
            self._landing_pool = None
        if self.fleet_publisher is not None:
            # ship the tail window with the final drain marker — the
            # fleet view's clean-shutdown signal (a replica that dies
            # before this goes DX542-stale instead)
            self.fleet_publisher.flush(final=True)
        if self.obs_server is not None:
            self.obs_server.stop()
            self.obs_server = None
        self.dispatcher.close()
        if close_sources:
            for s in self.sources.values():
                s.close()


def main(argv=None) -> StreamingHost:
    """``conf=<flow>.conf`` (required), ``batches=N`` (default: run until
    stopped) and ``device=cpu`` for a run on the CPU; the card
    otherwise. Returns the host it ran, stopped."""
    logging.basicConfig(level=logging.INFO)
    args = argv if argv is not None else sys.argv[1:]
    named = {
        a.split("=", 1)[0]: a.split("=", 1)[1] for a in args if "=" in a
    }
    ConfigManager.reset()
    ConfigManager.get_configuration_from_arguments(args)
    d = ConfigManager.load_config()
    host = StreamingHost(d, device=named.get("device", "cuda"))
    max_batches = int(named["batches"]) if "batches" in named else None
    logger.info(
        "starting flow %s on %s (interval=%ss, capacity=%s)",
        d.get_job_name(), host.device, host.interval_s,
        host.processor.batch_capacity,
    )
    try:
        host.run(max_batches)
    finally:
        host.stop()
    return host


if __name__ == "__main__":
    main()
