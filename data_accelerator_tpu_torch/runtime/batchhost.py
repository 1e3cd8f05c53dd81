"""BatchHost: one-shot / scheduled batch jobs over time-partitioned files.

reference: datax-host host/BlobBatchingHost.scala:25-110 — expands a
``{yyyy-MM-dd}``-style datetime pattern in the input path over
[startTime, endTime] stepping by partitionIncrement minutes (:28-53),
lists matching files, and runs the processor once over the whole file
set (``BatchApp.scala:10`` entry; batch conf read by
BatchBlobInputSetting from ``datax.job.input.batch.blob.<i>.*``).

Files are read host-side (gzip-aware), decoded into fixed-capacity
device batches, and pushed through the same FlowProcessor step the
streaming path uses — one engine, two drivers. A processed-files
tracker makes recurring runs idempotent (the reference gets this by
scheduling disjoint [start, end) windows; we keep that *and* tolerate
overlap).

The port of the JAX package's ``runtime/batchhost.py``: the same pass,
on a CUDA card (``device="cuda"``, the default, which raises without
one) or on the CPU when the caller asks for it. Its landing worker
enters the processor's card and the pass's stream.

Run: ``python -m data_accelerator_tpu_torch.runtime.batchhost conf=<flow>.conf [device=cpu]``
"""

from __future__ import annotations

import logging
import re
import sys
import time
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Tuple

import torch

from ..core.config import SettingDictionary, SettingNamespace
from ..core.confmanager import ConfigManager
from ..obs import telemetry, tracing
from ..obs.histogram import HISTOGRAMS
from ..obs.metrics import MetricLogger
from ..obs.tracing import Tracer
from ..utils import fs
from .processor import FlowProcessor, record_device_step
from .sinks import OutputDispatcher, build_output_operators
from .sources import read_json_file

logger = logging.getLogger(__name__)

# the reference accepts one datetime token of y/M/d/H/m/s/S with -/. or /
# separators (BlobBatchingHost.scala getDateTimePattern)
_DATETIME_TOKEN_RE = re.compile(r"\{([yMdHmsS\-/.]+)\}")


def _format_java(fmt: str, t: datetime) -> str:
    # single java-format token table lives in sources (the fs/ingest side)
    from .sources import _java_fmt_to_strftime

    return t.strftime(_java_fmt_to_strftime(fmt))


def get_input_blob_path_prefixes(
    path: str,
    start_time: datetime,
    processing_window_s: float,
    partition_increment_s: float,
) -> List[Tuple[str, datetime]]:
    """Expand the datetime token over the window, deduping partitions.

    reference: BlobBatchingHost.scala:28-53 getInputBlobPathPrefixes —
    walks t from 0..window stepping by the increment, substitutes the
    formatted partition folder, skips duplicates; a pattern-less path
    passes through unchanged.
    """
    m = _DATETIME_TOKEN_RE.search(path)
    if not m:
        logger.warning("input path has no datetime pattern: %s", path)
        return [(path, datetime.now(timezone.utc))]
    fmt = m.group(1)
    out: List[Tuple[str, datetime]] = []
    seen = set()
    t = 0.0
    while t <= processing_window_s:
        ts = start_time + timedelta(seconds=t)
        folder = _format_java(fmt, ts)
        if folder not in seen:
            seen.add(folder)
            out.append((path.replace("{" + fmt + "}", folder), ts))
        t += partition_increment_s
    return out


def get_batch_blobs_conf(dict_: SettingDictionary) -> List[Dict[str, str]]:
    """Read ``datax.job.input.batch.blob.<i>.*`` entries
    (reference: BatchBlobInputSetting.getInputBlobsArrayConf)."""
    sub = dict_.get_sub_dictionary("datax.job.input.batch.blob.")
    grouped = sub.group_by_sub_namespace()
    out = []
    for idx in sorted(grouped, key=lambda s: int(s) if s.isdigit() else 0):
        g = grouped[idx]
        out.append({
            "path": g.get_or_else("path", ""),
            "starttime": g.get_or_else("starttime", ""),
            "endtime": g.get_or_else("endtime", ""),
            "partitionincrement": g.get_or_else("partitionincrement", "1"),
        })
    return out


def _parse_iso(ts: str) -> datetime:
    t = datetime.fromisoformat(ts.replace("Z", "+00:00"))
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return t


class BatchHost:
    """Drives one batch run: expand prefixes -> list -> process -> sink."""

    def __init__(
        self,
        dict_: SettingDictionary,
        udfs: Optional[dict] = None,
        table_sink_map: Optional[Dict[str, list]] = None,
        tracker_path: Optional[str] = None,
        device: "torch.device | str" = "cuda",
    ):
        self.dict = dict_
        self.processor = FlowProcessor(dict_, udfs=udfs, device=device)
        self.metric_logger = MetricLogger.from_conf(dict_)
        self.telemetry = telemetry.from_conf(dict_)
        # same span/histogram surface as the streaming host: each chunk
        # is one trace (decode -> dispatch -> device-step -> sync ->
        # collect -> sinks), so batch and streaming latency live in one
        # measurement vocabulary
        tele_conf = dict_.get_sub_dictionary("datax.job.process.telemetry.")
        self.tracer = Tracer(
            self.telemetry,
            histograms=HISTOGRAMS,
            flow=dict_.get_job_name(),
            enabled=(
                tele_conf.get_or_else("tracing", "true") or ""
            ).lower() != "false",
            # batch jobs launched by the control plane join the
            # launching request's trace, same as streaming hosts
            parent=tele_conf.get("parenttrace"),
        )
        if table_sink_map is None:
            conf_outputs = dict_.get_sub_dictionary(
                SettingNamespace.JobOutputPrefix
            ).group_by_sub_namespace()
            table_sink_map = {name: [name] for name in conf_outputs}
        self.dispatcher = OutputDispatcher(
            build_output_operators(dict_, self.metric_logger, table_sink_map),
            self.metric_logger,
        )
        with self.processor.compile_scope():
            self.dispatcher.prepare()
        self.tracker_path = tracker_path or dict_.get(
            "datax.job.input.batch.blob.trackerfile"
        )
        self._processed: set = set()
        if self.tracker_path:
            try:
                self._processed = set(fs.read_lines(self.tracker_path))
            except FileNotFoundError:
                pass

    def list_files_to_process(self) -> List[str]:
        blobs = get_batch_blobs_conf(self.dict)
        files: List[str] = []
        for b in blobs:
            if not b["path"]:
                continue
            if b["starttime"] and b["endtime"]:
                start = _parse_iso(b["starttime"])
                end = _parse_iso(b["endtime"])
                window_s = (end - start).total_seconds()
                incr_s = float(b["partitionincrement"]) * 60.0
                if incr_s <= 0:
                    raise ValueError(
                        "datax.job.input.batch.blob partitionincrement "
                        f"must be positive, got {b['partitionincrement']!r}"
                    )
                prefixes = get_input_blob_path_prefixes(
                    b["path"], start, window_s, incr_s
                )
            else:
                prefixes = [(b["path"], datetime.now(timezone.utc))]
            for prefix, _ts in prefixes:
                files.extend(fs.list_files(prefix))
        return [f for f in sorted(set(files)) if f not in self._processed]

    def run(self) -> Dict[str, float]:
        """Process all pending files in capacity-sized device batches.

        reference: BlobBatchingHost.runBatchApp:70-110 — one processor
        pass over the listed files; here the fixed device batch shape
        chunks the row stream, same compiled step per chunk. Up to
        ``process.pipeline.depth`` chunks stay in flight (the
        generalized P6 overlap shared with
        ``StreamingHost.run_pipelined``); finishes are strictly FIFO so
        state-table commits happen in chunk order. With
        ``process.pipeline.backgroundtransfer`` (default on) a finish
        blocks only on the chunk's counts vector — the streamed output
        tables land and sinks run on a dedicated background landing
        worker (still FIFO: one worker, submission order), so file
        reads and device steps keep flowing while results land. A
        landing failure aborts the pass before the tracker file is
        written, so every file is reprocessed on rerun (at-least-once).
        """
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self.telemetry.track_event("datax/batch/app/begin")
        t0 = time.time()
        files = self.list_files_to_process()
        cap = self.processor.batch_capacity
        depth = max(1, self.processor.pipeline_depth)
        background = (
            (self.dict.get_sub_dictionary("datax.job.process.pipeline.")
             .get_or_else("backgroundtransfer", "true") or "")
            .lower() != "false"
        ) and self.processor.mesh is None
        totals: Dict[str, float] = {"Batch_Files_Count": float(len(files))}
        batch_time_ms = int(t0 * 1000)
        pending = deque()  # FIFO window of (handle, trace) in flight
        landings = deque()  # futures of chunk tails on the landing worker
        # the card and the stream the chunks' steps run on, current on
        # the landing worker too (CUDA state is per thread)
        dev = self.processor.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def enter_card():
            if stream is not None:
                torch.cuda.set_device(stream.device)
                torch.cuda.set_stream(stream)

        land_pool = (
            ThreadPoolExecutor(
                1, thread_name_prefix="landing", initializer=enter_card
            )
            if background else None
        )
        landing_failed: List[BaseException] = []

        def land(handle, trace) -> None:
            """The chunk tail behind the counts sync: resolve streamed
            tables, sinks, commit. Runs on the landing worker (or
            inline when background transfer is off)."""
            if landing_failed:
                handle.abandon()
                trace.end(status="aborted")
                return
            try:
                with trace.activate():
                    with tracing.span("collect"):
                        datasets, metrics = handle.collect_landed()
                    with tracing.span("sinks"):
                        self.dispatcher.dispatch(datasets, batch_time_ms)
                self.processor.commit()
                trace.end()
            except Exception as e:  # noqa: BLE001 — re-raised on the main pass
                trace.end(status="error")
                handle.abandon()
                landing_failed.append(e)
                return
            for k, v in metrics.items():
                # counts sum across chunks; point-in-time / per-chunk
                # latency values don't (a pipelined chunk's
                # dispatch->collect span absorbs the NEXT chunk's file
                # reads, and summing an epoch timestamp is meaningless)
                if k in ("Latency-Process", "BatchProcessedET",
                         "Transfer_Efficiency", "Pipeline_Depth",
                         "Transfer_Background_Pending",
                         "Transfer_Background_LandMs"):
                    continue
                totals[k] = totals.get(k, 0.0) + float(v)

        def check_landing_failure() -> None:
            if landing_failed:
                raise landing_failed[0]

        def finish(handle, trace) -> None:
            # counts-only sync on the main pass — the chunk's single
            # blocking device read; the tail lands out-of-band
            with trace.activate():
                with tracing.span("sync"):
                    handle.collect_counts()
            record_device_step(handle, trace)
            if land_pool is not None:
                landings.append(land_pool.submit(land, handle, trace))
            else:
                land(handle, trace)
                check_landing_failure()

        # the trace of the chunk the next row read goes to: it begins
        # when that chunk's first row is read, so each chunk's trace runs
        # from its reads to its landing
        next_trace = None

        def chunk_trace():
            nonlocal next_trace
            if next_trace is None:
                next_trace = self.tracer.begin(
                    "batch/chunk", batchTime=batch_time_ms
                )
            return next_trace

        def read(f: str) -> List[dict]:
            with chunk_trace().activate(), tracing.span("read", file=f) as props:
                got = read_json_file(f)
                props["lines"] = len(got)
            return got

        def flush(chunk: List[dict]):
            # dispatch chunk N; once `depth` chunks are in flight,
            # finish the oldest while the newer ones compute — file
            # reads and sink writes hide under the device steps
            nonlocal next_trace
            check_landing_failure()
            trace, next_trace = chunk_trace(), None
            with trace.activate(), tracing.span("decode", rows=len(chunk)):
                raw = self.processor.encode_rows(
                    chunk, (batch_time_ms // 1000) * 1000
                )
            with trace.activate(), tracing.span("dispatch"):
                handle = self.processor.dispatch_batch(raw, batch_time_ms)
            trace.mark("dispatch-done")
            pending.append((handle, trace))
            if len(pending) > depth:
                finish(*pending.popleft())
            # backpressure: queued landings never outgrow the window
            while len(landings) > depth:
                landings.popleft().result()

        # linear row buffering: consume via an index instead of
        # re-slicing the tail each chunk (`rows = rows[cap:]` re-copied
        # everything after the cut, O(n^2) over a multi-million-row
        # file set); the buffer compacts only when the dead prefix
        # dominates, keeping the whole pass amortized O(n)
        rows: List[dict] = []
        pos = 0
        try:
            for f in files:
                rows.extend(read(f))
                while len(rows) - pos >= cap:
                    flush(rows[pos:pos + cap])
                    pos += cap
                    if pos >= cap and pos * 2 >= len(rows):
                        del rows[:pos]
                        pos = 0
                if len(rows) > pos:
                    chunk_trace()  # this read gave the next chunk's first row
            if len(rows) > pos:
                flush(rows[pos:])
            if next_trace is not None:
                # reads that gave no row (empty files after the last chunk)
                next_trace.end(status="empty")
            while pending:
                finish(*pending.popleft())
            while landings:
                landings.popleft().result()
            check_landing_failure()
        except Exception as e:
            self.telemetry.track_exception(e, {"event": "error/batch/process"})
            if next_trace is not None:
                next_trace.end(status="error")
            for h, tr in pending:
                tr.end(status="error")  # idempotent
                h.abandon()
            while landings:  # settle queued tails (post-failure no-ops)
                try:
                    landings.popleft().result(timeout=60)
                except Exception:  # noqa: BLE001 — first failure already raised
                    pass
            raise
        finally:
            if land_pool is not None:
                land_pool.shutdown(wait=True)
        # tracker written only after a fully successful pass (at-least-once)
        self._processed.update(files)
        if self.tracker_path:
            fs.write_text(self.tracker_path, "\n".join(sorted(self._processed)) + "\n")
        totals["BatchProcessedET"] = float(batch_time_ms)
        totals["Latency-Batch"] = (time.time() - t0) * 1000.0
        self.metric_logger.send_batch_metrics(totals, batch_time_ms)
        self.telemetry.track_event(
            "datax/batch/end", measurements={k: float(v) for k, v in totals.items()}
        )
        logger.info("batch run done: %s", totals)
        return totals


def main(argv=None) -> Dict[str, float]:
    """``conf=<flow>.conf`` (required) and ``device=cpu`` for a run on
    the CPU; the card otherwise. Returns the pass's totals."""
    logging.basicConfig(level=logging.INFO)
    args = argv if argv is not None else sys.argv[1:]
    named = {
        a.split("=", 1)[0]: a.split("=", 1)[1] for a in args if "=" in a
    }
    ConfigManager.reset()
    ConfigManager.get_configuration_from_arguments(args)
    d = ConfigManager.load_config()
    return BatchHost(d, device=named.get("device", "cuda")).run()


if __name__ == "__main__":
    main()
