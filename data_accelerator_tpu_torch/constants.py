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
    and sinks use: the JAX package's registry of every engine-emitted
    metric name (``RUNTIME_METRIC_PATTERNS``) is not copied."""

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

