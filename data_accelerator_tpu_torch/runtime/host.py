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

Not ported yet, and refused by conf with an ``EngineException`` that
names them (``_refuse_unported``): alert rules (``obs/alerts.py``),
conformance monitoring (``obs/conformance.py``), the fleet telemetry
publisher (``obs/publisher.py``), the protocol monitor
(``runtime/protocolmonitor.py``) and machine-profile calibration files
(``obs/calibrate.py``). Absent without a conf to refuse: the ``Calib_*``
gauges (calibration), the boot conf audit (``runtime/confaudit.py``:
``Conf_*`` gauges, DX1006 events) and the on-demand ``/profile`` capture
(``obs/profiler.py``).

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
import logging
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

from ..constants import MetricName
from ..core.config import EngineException, SettingDictionary, SettingNamespace
from ..core.confmanager import ConfigManager
from ..obs import telemetry, tracing
from ..obs.exposition import HealthState, ObservabilityServer
from ..obs.histogram import HISTOGRAMS
from ..obs.metrics import MetricLogger
from ..obs.tracing import Tracer
from ..pilot.controller import PilotController
from .checkpoint import OffsetCheckpointer, WindowStateCheckpointer
from .processor import FlowProcessor
from .sinks import OutputDispatcher, build_output_operators
from .sources import LocalSource, StreamingSource, make_source

logger = logging.getLogger(__name__)


def _refuse_unported(dict_: SettingDictionary) -> None:
    """Raise for conf that asks for a host feature this port lacks,
    naming it, rather than run the flow without it."""
    proc = SettingNamespace.JobProcessPrefix
    obs = proc + "observability."
    checks = [
        (bool(dict_.get(proc + "alerts.rules")),
         "alert rules (process.alerts.rules, obs/alerts.py)"),
        (bool(dict_.get_sub_dictionary(proc + "conformance.").dict)
         or bool(dict_.get(proc + "mesh.model")),
         "conformance monitoring (process.conformance.*, obs/conformance.py)"),
        (bool(dict_.get(proc + "fleet.publishurl")),
         "fleet telemetry (process.fleet.publishurl, obs/publisher.py)"),
        ((dict_.get(proc + "debug.protocolmonitor") or "").lower() == "true",
         "the protocol monitor (process.debug.protocolmonitor, "
         "runtime/protocolmonitor.py)"),
        (bool(dict_.get(obs + "calibrationfile") or dict_.get(obs + "calibrationurl")),
         "machine-profile calibration (observability.calibrationfile/"
         "calibrationurl, obs/calibrate.py)"),
    ]
    for asked, feature in checks:
        if asked:
            raise EngineException(
                f"{feature} is not ported to data_accelerator_tpu_torch yet"
            )


class StreamingHost:
    def __init__(
        self,
        dict_: SettingDictionary,
        source: Optional[StreamingSource] = None,
        udfs: Optional[dict] = None,
        table_sink_map: Optional[Dict[str, list]] = None,
        device: "torch.device | str" = "cuda",
    ):
        _refuse_unported(dict_)
        self.dict = dict_
        self.processor = FlowProcessor(dict_, udfs=udfs, device=device)
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
        # live device-memory watermark sampling (observability.hbmsample,
        # default on): Hbm_BytesInUse/Hbm_PeakBytes each batch, absent
        # on the CPU, which reports no allocator stats
        self.hbm_sample = (
            (obs_conf.get_or_else("hbmsample", "true") or "").lower()
            != "false"
        )

        self.obs_server: Optional[ObservabilityServer] = None
        obs_port = obs_conf.get_int_option("port")
        if obs_port is not None:
            self.obs_server = ObservabilityServer(
                self.health,
                histograms=HISTOGRAMS,
                store=self.metric_logger.store,
                port=obs_port,
            )
            self.obs_server.start()

        if self.checkpointer:
            positions = self.checkpointer.starting_positions()
            for s in self.sources.values():
                s.start(positions)
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

        # sink routing: dataset -> output names; default: each conf output
        # name routes its same-named dataset (S500 contract)
        if table_sink_map is None:
            conf_outputs = dict_.get_sub_dictionary(
                SettingNamespace.JobOutputPrefix
            ).group_by_sub_namespace()
            table_sink_map = {name: [name] for name in conf_outputs}
        operators = build_output_operators(dict_, self.metric_logger, table_sink_map)
        self.dispatcher = OutputDispatcher(operators, self.metric_logger)

        self.batches_processed = 0
        self._stop = False

        # background result landing: in the pipelined loop the only
        # BLOCKING device read per batch is the counts vector; the
        # batch tail (collect_tables -> sinks -> commit -> ack ->
        # metrics -> checkpoint) runs on this one-thread landing
        # executor, so landings stay strictly FIFO while the dispatch
        # loop keeps feeding the device. Conf
        # datax.job.process.pipeline.backgroundtransfer (default on).
        pipe_conf = dict_.get_sub_dictionary(
            SettingNamespace.JobProcessPrefix + "pipeline."
        )
        self.background_transfer = (
            (pipe_conf.get_or_else("backgroundtransfer", "true") or "")
            .lower() != "false"
        )
        self._landing_pool = (
            ThreadPoolExecutor(
                1, thread_name_prefix="landing", initializer=self._enter_card
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

    # -- per-thread CUDA state --------------------------------------------
    def _enter_card(self) -> None:
        """Make the processor's card and the host's stream current on
        the calling thread for good (a worker thread's initializer)."""
        if self._stream is not None:
            torch.cuda.set_device(self._stream.device)
            torch.cuda.set_stream(self._stream)

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
                blob, _n, c = src.poll_raw(max_events)
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
            trace.record_since("device-step", "dispatch-done")
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
        tables, run sinks, commit state, ack sources, emit metrics,
        checkpoint."""
        try:
            with trace.activate():
                land_t0 = time.time()
                with tracing.span("collect"):
                    datasets, metrics = handle.collect_tables()
                land_ms = (time.time() - land_t0) * 1000.0
                with tracing.span("sinks"):
                    self.dispatcher.dispatch(datasets, batch_time_ms)
                self.processor.commit()
                for s in self.sources.values():
                    s.ack()
        except Exception as e:
            self.telemetry.track_exception(
                e, {"event": "error/streaming/process", "batchTime": batch_time_ms}
            )
            self.health.record_batch(
                batch_time_ms, ok=False, error=f"{type(e).__name__}: {e}"
            )
            trace.end(status="error")
            if requeue_on_error:
                for s in self.sources.values():
                    s.requeue_unacked()
            logger.exception("batch processing failed; rethrowing for retry")
            raise

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
        self.telemetry.batch_end(batch_time_ms, {"latencyMs": metrics["Latency-Batch"]})
        self.metric_logger.send_batch_metrics(metrics, batch_time_ms)
        logger.info(
            "batch %d: %s",
            self.batches_processed + 1,
            " ".join(f"{k}={v:.1f}" for k, v in sorted(metrics.items())),
        )
        # post-commit at-least-once replay cursor: the window snapshot
        # and the offset commit run AFTER the ack on purpose — a crash
        # between ack and checkpoint replays from the previous offsets
        # into rings that already hold the events (duplicates, never
        # loss)
        if self.checkpointer and (
            t0 - self._last_checkpoint >= self.checkpoint_interval_s
        ):
            with trace.activate(), tracing.span("checkpoint"):
                if self.window_checkpointer:
                    # snapshot BEFORE offsets: a crash between the two
                    # leaves old offsets + new rings (at-least-once
                    # duplicates); the reverse order would resume PAST
                    # events the restored rings never saw
                    self.window_checkpointer.save(
                        self.processor.snapshot_window_state()
                    )
                self.checkpointer.checkpoint_batch(consumed)
            self._last_checkpoint = t0
            self.health.record_checkpoint()
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
        while not self._stop:
            start = time.time()
            self.run_batch()
            if max_batches is not None and self.batches_processed >= max_batches:
                break
            sleep = self.interval_s - (time.time() - start)
            if sleep > 0:
                time.sleep(sleep)

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
        pool = ThreadPoolExecutor(1, initializer=self._enter_card)
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

    def stop(self, close_sources: bool = True) -> None:
        """``close_sources=False`` tears the host down but leaves its
        sources open, for a successor host to take over the surviving
        source/checkpoint state the way a rescheduled job takes over its
        partitions."""
        self._stop = True
        if self._landing_pool is not None:
            # let queued landings flush their sinks/acks before the
            # dispatcher and sources close underneath them
            self._settle_landings()
            self._landing_pool.shutdown(wait=True)
            self._landing_pool = None
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
