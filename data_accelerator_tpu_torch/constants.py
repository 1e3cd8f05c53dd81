"""Product-wide constants.

Mirrors the reference's ``datax-core`` constants package
(``DataProcessing/datax-core/src/main/scala/datax/constants/*.scala``) so
that flow configs, metric names and dataset names written for the
reference keep their meaning here.
"""

import os

# reference: NamePrefix.scala:8-11
NAME_PREFIX = os.environ.get("DATAX_NAMEPREFIX", "DataX")


# Memory the LiveQuery warm-kernel budget takes as one device's when the
# port runs on the CPU (analysis/costmodel.py::warm_kernel_cache_budget_bytes):
# the host's memory is shared with everything else the process holds, so
# the serving plane's resident kernels are priced against 4 GiB, a size
# of the port's own. On a card the budget reads the card's total memory
# (torch.cuda.get_device_properties) instead.
CPU_DEVICE_MEMORY_BYTES = 4 * 1024 ** 3


class ProductConstant:
    """reference: ProductConstant.scala:8-22"""

    DefaultAppName = f"{NAME_PREFIX}_Unknown_App"
    MetricAppNamePrefix = f"{NAME_PREFIX}-".upper()
    ProductRoot = NAME_PREFIX.lower()
    ProductJobTags = f"{NAME_PREFIX}JobTags"
    ProductOutputFilter = f"{NAME_PREFIX}OutputFilter"
    # regex matching a query-separator line
    ProductQuery = rf"^--{NAME_PREFIX}Query--"
    # the states separator introducing accumulation-table DDL
    # (reference: DataX.Flow.CodegenRules/Engine.cs rule-state handling)
    ProductStates = rf"^--{NAME_PREFIX}States--"


class ColumnName:
    """reference: ColumnName.scala:10-25"""

    RawObjectColumn = "Raw"
    EventNameColumn = "EventName"
    PropertiesColumn = f"{NAME_PREFIX}Properties"
    RawPropertiesColumn = "Properties"
    RawSystemPropertiesColumn = "SystemProperties"
    InternalColumnPrefix = f"__{NAME_PREFIX}_"
    InternalColumnFileInfo = InternalColumnPrefix + "FileInfo"
    MetadataColumnPrefix = f"__{NAME_PREFIX}Metadata_"
    MetadataColumnOutputPartitionTime = MetadataColumnPrefix + "OutputPartitionTime"
    OutputGroupColumn = f"{NAME_PREFIX}OutputGroup"


class DatasetName:
    """reference: DatasetName.scala:8-13"""

    DataStreamRaw = f"{NAME_PREFIX}RawInput"
    DataStreamProjection = f"{NAME_PREFIX}ProcessedInput"
    DataStreamProjectionBatch = f"{NAME_PREFIX}ProcessedInput_Batch"
    DataStreamProjectionWithWindow = f"{NAME_PREFIX}ProcessedInput_Window"


class JobArgument:
    """reference: JobArgument.scala:9-21 — env-var names the job honors."""

    ConfNamePrefix = f"{NAME_PREFIX}_".upper()
    ConfName_AppConf = ConfNamePrefix + "APPCONF"
    ConfName_AppName = ConfNamePrefix + "APPNAME"
    ConfName_LogLevel = ConfNamePrefix + "LOGLEVEL"
    ConfName_CheckpointEnabled = ConfNamePrefix + "CHECKPOINTENABLED"
    ConfName_BlobWriterTimeout = ConfNamePrefix + "BlobWriterTimeout"


class MetricName:
    """reference: MetricName.scala:8, trimmed to what the port's hosts
    and sinks use, with the JAX package's registry of every
    engine-emitted metric name (``RUNTIME_METRIC_PATTERNS``,
    ``is_runtime_metric``) copied whole: it covers the port's
    ``Sanitizer_*``, ``State_*``, ``Calib_*`` and ``Fleet_*`` families
    too, and the mesh and compile-cache names the port does not emit
    yet."""

    # fleet telemetry plane (obs/publisher.py + obs/fleetview.py):
    # publisher self-metrics and aggregator-side counters, referenced
    # by name from both modules so the emit sites and the registry
    # cannot drift
    FLEET_FRAMES = "Fleet_Frames_Count"
    FLEET_FRAME_BYTES = "Fleet_Frame_Bytes"
    FLEET_FRAME_PUBLISH_MS = "Fleet_FramePublish_Ms"
    FLEET_FRAME_PUBLISH_ERROR = "Fleet_FramePublishError_Count"
    FLEET_FRAME_DECODE_ERROR = "Fleet_FrameDecodeError_Count"
    FLEET_MERGE_LATENCY_MS = "Fleet_MergeLatency_Ms"

    # runtime conf audit (runtime/confaudit.py, run at every
    # StreamingHost init): keys audited against the conf registry, keys
    # no registry row governs, and keys whose value violated its row's
    # type/bounds — runtime DX1006
    CONF_AUDITED = "Conf_Audited_Count"
    CONF_UNKNOWN = "Conf_Unknown_Count"
    CONF_OUT_OF_BOUNDS = "Conf_OutOfBounds_Count"

    # partitioned state (runtime/statetable.py, runtime/statepartition.py),
    # drained at each collect: the partition geometry this replica runs,
    # the successor's handoff cost (state pull + restore at init),
    # corrupt-snapshot fallbacks (DX530/531), snapshot pushes/pulls
    # through the objstore mirror, rows the key-routed ingest filter
    # dropped as un-owned, and window rows dropped when a merge overflowed
    # a ring slot. The JAX package's State_Partition_Reassigned_Count is
    # the control plane's rescale's (serve/jobs.py), not the engine's.
    STATE_METRICS = (
        "State_Partition_Count",
        "State_Partition_Owned",
        "State_Handoff_Ms",
        "State_LoadFallback_Count",
        "State_Snapshot_Push_Count",
        "State_Snapshot_Pull_Count",
        "State_IngestFiltered_Count",
        "State_WindowRows_Dropped_Count",
    )

    MetricSinkPrefix = "Sink_"
    # the rows the file sink rendered from a landed table's columns
    SinkFileColumnarRows = "Sink_file_ColumnarRows"
    # a batch's windowed GROUP BYs: the ring rows they sorted, the valid
    # rows in their window spans, the groups they formed
    GroupRowsScanned = "Group_RowsScanned"
    GroupRowsInWindow = "Group_RowsInWindow"
    GroupCount = "Group_Count"
    LatencyPrefix = "Latency-"

    # canonical per-batch stage names (span names == histogram stages ==
    # the <stage> of Latency-<stage> metrics, modulo capitalization)
    STAGES = (
        "decode", "dispatch", "device-step", "sync", "collect",
        "sinks", "checkpoint", "batch", "lq-exec",
    )

    # stages whose metric stem is not the plain CamelCase of the stage
    # name (acronym casing)
    _STAGE_METRIC_OVERRIDES = {"lq-exec": "Latency-LQExec"}

    # regexes over the metric part of ``DATAX-<flow>:<metric>`` covering
    # everything the engine emits at runtime (host + processor + sinks +
    # histogram percentile series). Anchored full-match.
    RUNTIME_METRIC_PATTERNS = (
        # raw per-batch latencies (back-compat dashboard series)
        r"Latency-(Batch|Process)",
        # per-stage histogram percentiles (obs/histogram.py)
        r"Latency-(Decode|Dispatch|DeviceStep|Sync|Collect|Sinks|"
        r"Checkpoint|Batch)-p(50|95|99)",
        r"BatchProcessedET",
        r"IngestRateScale",
        r"Input_[A-Za-z0-9_.]+_Events_Count",
        r"Input_[A-Za-z0-9_.]+_Count",
        # Kafka record batches skipped by the per-batch CRC-32C check
        # (runtime/kafka_wire.py decode_record_batches + the native
        # walker) — covered by the Input_*_Count family above, listed
        # explicitly because the pilot/alert surfaces reference it
        r"Input_CorruptBatch_Count",
        # ingest decode fast path (csrc/decoder.cpp via
        # runtime/processor.py encode_json_bytes): conf'd decoder shard
        # count in effect, last measured decode rate, and reuses of the
        # pooled transfer-ready ingest matrices since the last collect
        r"Decode_Shards",
        r"Decode_RowsPerSec",
        r"Decode_BufferReuse_Count",
        r"Output_[A-Za-z0-9_.]+_Events_Count",
        r"Output_[A-Za-z0-9_.]+_(GroupsDropped|JoinRowsDropped)",
        r"Sink_[a-z]+",
        r"Batch_Files_Count",
        # UDF on_interval hooks that threw (refresh skipped, previous
        # trace kept serving — runtime/processor.py dispatch_batch)
        r"UdfRefreshError",
        # depth-N pipelined window (runtime/host.py run_pipelined):
        # in-flight depth at finish time + ms the dispatch loop stalled
        # waiting for the window's oldest batch
        r"Pipeline_Depth",
        r"Pipeline_Stall_Ms",
        # sized output transfer (runtime/processor.py PendingBatch):
        # D2H bytes per batch, valid/transferred row ratio, and the
        # async-copy-capability / sized-cap-overflow / slot-contention
        # fallback counters
        r"Transfer_D2HBytes",
        r"Transfer_Efficiency",
        r"Transfer_(AsyncCopyFallback|Overflow|SlotContended)_Count",
        # buffer sanitizer (runtime/sanitizer.py, armed via
        # process.debug.buffersanitizer): buffers guarded per collect,
        # and use-after-release detections — runtime DX805, the dynamic
        # half of the DX8xx buffer-lifetime analyzer
        r"Sanitizer_GuardedViews_Count",
        r"Sanitizer_PoisonHit_Count",
        # protocol monitor (runtime/protocolmonitor.py, armed via
        # process.debug.protocolmonitor): delivery-protocol events
        # recorded per batch tail, and sealed-batch ordering violations
        # — runtime DX906, the dynamic half of the DX9xx exactly-once
        # protocol analyzer
        r"Protocol_Events_Count",
        r"Protocol_Violation_Count",
        # conf audit (runtime/confaudit.py, armed at host/LQ-service
        # init): process-namespace keys audited against the typed conf
        # registry (analysis/confspec.py), unknown keys, and
        # type/bounds violations — runtime DX1006, the dynamic half of
        # the DX10xx configuration-lattice analyzer
        r"Conf_Audited_Count",
        r"Conf_Unknown_Count",
        r"Conf_OutOfBounds_Count",
        # device-resident result path (runtime/processor.py
        # collect_counts + runtime/host.py background landing): bytes
        # the blocking counts-only sync moved, landings still queued
        # when a batch's tail was submitted to the background transfer
        # thread, and the ms its streamed tables took to resolve there
        r"Sync_CountsBytes",
        r"Transfer_Background_(Pending|LandMs)",
        # jit re-traces observed since the last collect (UDF refresh
        # rebuilds + shape/dictionary-growth cache misses); the
        # conformance monitor's DX503 input
        r"Retrace_Count",
        # observed mesh communication (dist/mesh.py collective_summary,
        # exported by the mesh processor per batch): ring-convention
        # wire bytes of the executed program's collectives and its
        # collective-op count — the runtime counterpart of the DX7xx
        # sharding model, judged by the DX510/DX511 conformance checks
        r"Mesh_ICI_Bytes",
        r"Mesh_Reshard_Count",
        # model-vs-observed conformance (obs/conformance.py): windowed
        # observed/predicted ratios against the cost-model report
        # embedded in the conf, plus the cumulative drift-event count
        r"Conformance_D2HBytes_Ratio",
        r"Conformance_Occupancy_[A-Za-z0-9_.]+_Ratio",
        # mesh ICI drift ratio (observed Mesh_ICI_Bytes / the embedded
        # sharding model's wire prediction — the DX510 gauge)
        r"Conformance_MeshIci_Ratio",
        # roofline time-model conformance (obs/conformance.py DX520/
        # DX521): observed per-stage latency p50 / the calibrated
        # roofline prediction, one gauge per predicted stage
        r"Conformance_StageTime_[A-Za-z]+_Ratio",
        # live HBM peak / the DX2xx modeled footprint (the DX522 gauge)
        r"Conformance_Hbm_Ratio",
        r"Conformance_Drift_Count",
        # calibrated machine profile (obs/calibrate.py): the measured
        # constants the roofline predictions are priced with — HBM
        # read/write GB/s, dense GFLOP/s, per-dispatch overhead µs,
        # D2H GB/s and (under a mesh) ICI GB/s
        r"Calib_HbmReadGBps",
        r"Calib_HbmWriteGBps",
        r"Calib_FlopsGFlops",
        r"Calib_DispatchOverheadUs",
        r"Calib_D2HGBps",
        r"Calib_IciGBps",
        # measured host JSON-decode rate (native decoder probe) — the
        # constant pricing the latency model's decode term, the DX520
        # baseline for stage_decode_ms
        r"Calib_DecodeRowsPerSec",
        # live HBM watermark sampler (runtime/processor.py
        # device_memory_stats, exported per batch when the backend
        # reports allocator stats)
        r"Hbm_BytesInUse",
        r"Hbm_PeakBytes",
        # on-demand profiler surface (obs/profiler.py): cumulative
        # finished captures this host has written
        r"Profiler_Captures_Count",
        # AOT compile + persistent compilation cache
        # (runtime/processor.py process.compile.*): init-time warm cost,
        # persistent-cache hit/miss counts at cache-entry granularity,
        # warm-start promises missed (a dispatch compiled after an AOT
        # warm — the runtime face of DX604), shipped-manifest drift
        # detected at warm time (the runtime face of DX603), and
        # LRU evictions from the bounded transfer-helper jit caches
        r"Compile_ColdStart_Ms",
        r"Compile_Cache_(Hit|Miss)_Count",
        r"Compile_WarmMiss_Count",
        r"Compile_ManifestDrift_Count",
        r"Compile_JitCacheEvict_Count",
        # alert engine (obs/alerts.py): count of currently-firing rules,
        # exported every evaluation so dashboards can chart alert state
        r"Alerts_Firing",
        # autopilot (pilot/controller.py, exported once per evaluation
        # window): cumulative actuations applied / decisions held by
        # budget+cooldown, the live pipeline depth the controller is
        # running, and the backpressure token-bucket balance
        r"Pilot_Actuations_Count",
        r"Pilot_Suppressed_Count",
        r"Pilot_Depth",
        r"Pilot_Backpressure_Tokens",
        # partitioned state & rescale (runtime/statetable.py +
        # runtime/statepartition.py, drained at collect; the
        # Partition_Reassigned count is emitted under DATAX-Fleet by
        # JobOperation.rescale): partition geometry this replica runs,
        # successor handoff cost (state pull + restore at init),
        # corrupt-snapshot fallbacks (DX530/531), snapshot pushes/pulls
        # through the objstore mirror, rows the key-routed ingest
        # filter dropped as un-owned, and window rows dropped when a
        # merge overflowed a ring slot
        r"State_Partition_Count",
        r"State_Partition_Owned",
        r"State_Partition_Reassigned_Count",
        r"State_Handoff_Ms",
        r"State_LoadFallback_Count",
        r"State_Snapshot_(Push|Pull)_Count",
        r"State_IngestFiltered_Count",
        r"State_WindowRows_Dropped_Count",
        # fleet placement (serve/jobs.py FleetAdmissionGate, emitted
        # under the DATAX-Fleet app on every admission check / re-plan):
        # fleet-wide chip/flow counts, per-chip packed HBM and
        # utilization from the DX4xx placement plan, admission
        # rejections, and re-plan rounds (serve/scheduler.py
        # PlacementReplanner)
        r"Fleet_Chips",
        r"Fleet_Flows(Placed|Unplaced)",
        r"Fleet_MaxChipUtilization",
        r"Fleet_Chip[0-9]+_(HbmBytes|Utilization)",
        r"Fleet_AdmissionRejected_Count",
        r"Placement_Replans_Count",
        # fleet telemetry plane (obs/publisher.py frames published /
        # last frame bytes / publish latency / failed publishes, and
        # obs/fleetview.py corrupt frames skipped, cross-replica merge
        # latency, replica liveness gauges)
        r"Fleet_Frames_Count",
        r"Fleet_Frame_Bytes",
        r"Fleet_FramePublish_Ms",
        r"Fleet_FramePublishError_Count",
        r"Fleet_FrameDecodeError_Count",
        r"Fleet_MergeLatency_Ms",
        r"Fleet_(Replicas|StaleReplicas)_Count",
        # delivery-conservation audit (obs/fleetview.py DX540/541/542):
        # cumulative audit findings per flow over the merged lineage
        r"Conformance_Delivery_(Loss|Duplicate|StaleReplica)_Count",
        # LiveQuery serving plane (lq/service.py, exported under the
        # DATAX-LiveQuery app): live session/tenant gauges, completed
        # execute QPS over a trailing 10 s window, queued-not-yet-
        # dispatched calls (the pilot-visible pressure signal the
        # lq-latency-slo alert rule votes backpressure on), mean calls
        # merged per dispatch tick, cumulative device dispatches and
        # calls that shared one (the coalescing win), resident
        # warm-kernel HBM priced by the DX2xx model, LRU evictions from
        # the modeled budget, and typed admission/quota rejections
        # (rejected calls never reach a device dispatch)
        r"LQ_Sessions",
        r"LQ_Tenants",
        r"LQ_Qps",
        r"LQ_Backlog",
        r"LQ_CoalesceFanin",
        r"LQ_Dispatch_Count",
        r"LQ_Coalesced_Count",
        r"LQ_KernelBytes",
        r"LQ_KernelEvict_Count",
        r"LQ_Admission_Rejected_Count",
        # end-to-end LiveQuery execute latency (queue wait + coalesced
        # dispatch), the serving plane's interactive-latency histogram
        # (exemplar-bearing like every Latency-* family)
        r"Latency-LQExec-p(50|95|99)",
    )
    # the port's own names, beyond the JAX package's registry above:
    # the rows a sink rendered straight from a landed table's columns
    # (runtime/sinks.py OutputOperator: Sink_file_ColumnarRows beside
    # Sink_file, the blob sink's native JSON-lines route), and the
    # windowed GROUP BYs' counters (runtime/processor.py collect_landed)
    PORT_RUNTIME_METRIC_PATTERNS = (
        SinkFileColumnarRows, GroupRowsScanned, GroupRowsInWindow, GroupCount,
    )
    RUNTIME_METRIC_PATTERNS = RUNTIME_METRIC_PATTERNS + PORT_RUNTIME_METRIC_PATTERNS

    @classmethod
    def is_runtime_metric(cls, metric: str) -> bool:
        """True when ``metric`` (the part after ``DATAX-<flow>:``) is a
        registered engine-emitted name."""
        import re

        return any(
            re.fullmatch(p, metric) for p in cls.RUNTIME_METRIC_PATTERNS
        )

    @staticmethod
    def metric_app_name(job_name: str) -> str:
        """The ``DATAX-<job>`` metric app key a flow's series live
        under in the MetricStore."""
        return ProductConstant.MetricAppNamePrefix + job_name

    @classmethod
    def stage_metric(cls, stage: str) -> str:
        """Histogram stage -> its metric stem, e.g. ``device-step`` ->
        ``Latency-DeviceStep``."""
        override = cls._STAGE_METRIC_OVERRIDES.get(stage)
        if override is not None:
            return override
        camel = "".join(w.capitalize() for w in stage.split("-"))
        return f"Latency-{camel}"


class ProcessingPropertyName:
    """reference: ProcessingPropertyName.scala:8-14"""

    BlobPathHint = "Partition"
    BatchTime = "BatchTime"
    BlobTime = "InputTime"
    CPTime = "CPTime"
    CPExecutor = "CPExecutor"



class FeatureName:
    """reference: FeatureName.scala:8-10"""

    FunctionDisableCommonCaching = "disableCommonCaching"
