"""LiveQuery: interactive query kernels over sampled live data.

reference: DataX.Flow/DataX.Flow.InteractiveQuery —
``InteractiveQueryManager`` creates a remote Jupyter kernel on the Spark
cluster (HDInsightKernelService.cs:47-57), initializes it with the
flow's sampled input + normalization + UDFs/refdata
(KernelService.cs:67-130), executes the user's query and returns table
JSON capped at a max row count (KernelService.cs:451-540), and recycles
kernels via a tracked kernel list (KernelService.cs:135-190).

A kernel is an in-process object holding the sampled batch; queries
compile through the SAME FlowProcessor pipeline compiler the production
engine uses. Compiled processors are cached per query text, so
re-running an edited query only rebuilds the change.

A copy of the JAX package's ``serve/livequery.py`` with these changes:

- ``Kernel`` and ``KernelService`` take ``device`` (``"cuda"`` by
  default) and build every processor there; ``KernelService`` raises
  at construction when the device is a card and none is present.
- One lock per processor is held across its reset, encode and step.
  The port's window rings change in place, so a reset from one thread
  must not land inside another thread's step on the same processor;
  the rows each caller gets equal a serial run's.
- ``debug`` writes ``process.debug.*`` as in the JAX package, and arms
  the port's step guards (``runtime/debugguard.py``): ``nans`` raises
  ``FloatingPointError`` at a NaN a UDF or view computes,
  ``tracerleaks`` a ``TensorLeakError`` for a step tensor a UDF keeps.
- ``compile_conf`` (``process.compile.*``) is kept and passed on, but no
  persistent compile cache reads it in the port: a re-warm is a rebuild.
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..compile.transform_parser import TransformParser
from ..constants import DatasetName
from ..core.config import EngineException, SettingDictionary

_WINDOWED_TABLE_RE = re.compile(rf"\b{DatasetName.DataStreamProjection}_\w+\b")
# production TIMEWINDOW table naming: <projection>_<N><unit>
_WINDOW_NAME_RE = re.compile(
    rf"\b{DatasetName.DataStreamProjection}_(\d+)([A-Za-z]+)\b"
)
_DURATION_UNITS = {
    "second", "seconds", "minute", "minutes", "hour", "hours",
    "day", "days", "millisecond", "milliseconds",
}

DEFAULT_MAX_ROWS = 100
DEFAULT_KERNEL_TTL_S = 30 * 60
DEFAULT_MAX_KERNELS = 16


def _capacity_for(n: int) -> int:
    cap = 64
    while cap < n:
        cap *= 2
    return cap


def require_device(device: "torch.device | str") -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a card and no
    CUDA device is present (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise EngineException(
            f"LiveQuery device {str(dev)!r}: no CUDA device is present "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev


@dataclass
class Kernel:
    """One interactive session's compiled state."""

    id: str
    flow_name: str
    schema_json: str
    normalization: str
    sample_rows: List[dict]
    udfs: Optional[dict] = None
    refdata_conf: Dict[str, str] = field(default_factory=dict)
    # process.debug.* flags for UDF-bearing interactive runs: True arms
    # both nans and tracerleaks (runtime/debugguard.py), a dict selects
    # flags ({"nans": "true"})
    debug: object = None
    # compile conf keys (datax.job.process.compile.*) merged into every
    # query processor's conf: the kernel build cache its kernels share
    compile_conf: Dict[str, str] = field(default_factory=dict)
    device: str = "cuda"
    created_at: float = field(default_factory=time.time)
    last_used: float = field(default_factory=time.time)
    _processors: Dict[str, object] = field(default_factory=dict)
    # guards _processors; each processor has its own lock in _exec_locks
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _exec_locks: Dict[str, threading.Lock] = field(default_factory=dict)
    # query texts whose processor has run since it was built
    _ran: set = field(default_factory=set)

    def _conf(self, transform_text: str, windows: Dict[str, str],
              max_window_s: float) -> SettingDictionary:
        conf = {
            "datax.job.name": f"LiveQuery-{self.flow_name}",
            "datax.job.input.default.inputtype": "local",
            "datax.job.input.default.blobschemafile": self.schema_json,
            "datax.job.process.transform": transform_text,
            "datax.job.process.projection": self.normalization,
        }
        if windows:
            conf.update(windows)
            conf["datax.job.process.timestampcolumn"] = self._timestamp_column()
            conf["datax.job.process.watermark"] = "0 second"
            # the kernel runs ONE batch; sizing the interval to the max
            # window keeps the ring at 2 slots instead of window/1s
            conf["datax.job.input.default.streaming.intervalinseconds"] = str(
                max(1, int(max_window_s))
            )
        conf.update(self.refdata_conf)
        conf.update(self.compile_conf)
        if self.debug:
            flags = (
                {"nans": "true", "tracerleaks": "true"}
                if self.debug is True
                else {k: str(v).lower() for k, v in dict(self.debug).items()}
            )
            for k, v in flags.items():
                conf[f"datax.job.process.debug.{k}"] = v
        return SettingDictionary(conf)

    def _timestamp_column(self) -> Optional[str]:
        """The time axis windows evict against: the schema's first
        TIMESTAMP column, else the alias a current_timestamp()
        normalization line introduces. Cached — called per execute."""
        if not hasattr(self, "_ts_col"):
            from ..core.schema import ColType, Schema

            col = None
            try:
                schema = Schema.from_spark_json(self.schema_json)
                for c in schema.columns:
                    if c.ctype == ColType.TIMESTAMP:
                        col = c.name
                        break
            except (ValueError, KeyError):
                pass
            if col is None:
                m = re.search(
                    r"current_timestamp\(\)\s+AS\s+(\w+)",
                    self.normalization, re.I,
                )
                col = m.group(1) if m else None
            self._ts_col = col
        return self._ts_col

    def _window_confs(self, query: str):
        """TIMEWINDOW conf entries for every windowed table the query
        names, parsed from the production ``<projection>_<N><unit>``
        naming — so the kernel runs the SAME ring-buffer/watermark
        window machinery as the production engine
        (reference's same-engine promise, KernelService.cs:104-130),
        with the sample's own time axis deciding what's in-window."""
        if self._timestamp_column() is None:
            return {}, 0.0
        confs: Dict[str, str] = {}
        max_s = 0.0
        for n, unit in set(_WINDOW_NAME_RE.findall(query)):
            if unit.lower() not in _DURATION_UNITS:
                continue
            name = f"{DatasetName.DataStreamProjection}_{n}{unit}"
            confs[
                f"datax.job.process.timewindow.{name}.windowduration"
            ] = f"{n} {unit}"
            scale = {
                "millisecond": 0.001, "second": 1, "minute": 60,
                "hour": 3600, "day": 86400,
            }[unit.lower().rstrip("s")]
            max_s = max(max_s, int(n) * scale)
        return confs, max_s

    def _rewrite_windowed(self, query: str, windows: Dict[str, str]) -> str:
        """Windowed tables the production naming does NOT cover (no
        parseable duration) alias to the full sample as a fallback;
        properly-named ones run the real TIMEWINDOW machinery via
        ``_window_confs``."""
        real = {
            key.split(".timewindow.", 1)[1].rsplit(".", 1)[0]
            for key in windows
        }
        return _WINDOWED_TABLE_RE.sub(
            lambda m: m.group(0)
            if m.group(0) in real
            else DatasetName.DataStreamProjection,
            query,
        )

    def _sample_base_ms(self) -> int:
        """The sample's own epoch-ms origin: the max value of the
        schema's TIMESTAMP columns across sampled rows — string and
        nested timestamps included (falls back to now for
        timestamp-less samples)."""
        from ..core.batch import _dig, parse_timestamp_ms
        from ..core.schema import ColType, Schema

        try:
            schema = Schema.from_spark_json(self.schema_json)
        except (ValueError, KeyError):
            return int(time.time() * 1000)
        ts_cols = [c.name for c in schema.columns if c.ctype == ColType.TIMESTAMP]
        best = 0
        for r in self.sample_rows:
            for cname in ts_cols:
                v = _dig(r, cname)
                if isinstance(v, str):
                    v = parse_timestamp_ms(v)
                if isinstance(v, (int, float)) and v > 0:
                    best = max(best, int(v))
        return best or int(time.time() * 1000)

    def execute(self, query: str, max_rows: int = DEFAULT_MAX_ROWS) -> dict:
        """Compile + run the query against the sampled batch; returns
        {"headers": [...], "result": [rows]} like the reference's
        ConvertToJson (KernelService.cs:700)."""
        from ..runtime.processor import FlowProcessor

        self.last_used = time.time()
        windows, max_window_s = self._window_confs(query)
        text = self._rewrite_windowed(query.strip(), windows)
        if not text:
            return {"headers": [], "result": []}

        # target dataset: last named assignment in the script
        parsed = TransformParser.parse(text.splitlines())
        names = [c.name for c in parsed.commands if c.name]
        if not names:
            # bare SELECT: wrap into an assignment
            text = f"__livequery__ = {text}"
            names = ["__livequery__"]
        target = names[-1]

        with self._lock:
            proc = self._processors.get(text)
            if proc is None:
                proc = FlowProcessor(
                    self._conf(text, windows, max_window_s),
                    batch_capacity=_capacity_for(len(self.sample_rows)),
                    output_datasets=[target],
                    udfs=self.udfs,
                    device=self.device,
                )
                self._processors[text] = proc
                self._exec_locks[text] = threading.Lock()
            exec_lock = self._exec_locks[text]
            rows_now = self.sample_rows

        # anchor the batch at the SAMPLE's time base, not the wall
        # clock: sampled blobs may be hours/days old and relative int32
        # times must stay small (production gets this for free — live
        # batches are near now)
        base_ms = self._sample_base_ms()
        with exec_lock:
            if text in self._ran:
                # a cached processor holds ring/state from its last run;
                # kernel executes are idempotent, so start clean
                proc.reset_state()
            self._ran.add(text)
            raw = proc.encode_rows(rows_now, (base_ms // 1000) * 1000)
            datasets, _metrics = proc.process_batch(raw, batch_time_ms=base_ms)
        rows = datasets.get(target, [])[:max_rows]
        headers = list(rows[0].keys()) if rows else []
        return {"headers": headers, "result": rows, "table": target}


class KernelService:
    """Kernel registry with TTL GC (KernelService.cs:135-190 analog).

    The registry itself is the serving plane's ``SessionManager``
    (``lq/session.py``) — kernels live as sessions under the legacy
    tenant, so BOTH interactive surfaces (these designer kernels and
    the multi-tenant ``lq/`` session service) share one registry, one
    TTL clock and one reap pass, which reaps on EVERY access path
    (create, get, execute, list)."""

    def __init__(
        self,
        runtime_storage=None,
        ttl_s: float = DEFAULT_KERNEL_TTL_S,
        max_kernels: int = DEFAULT_MAX_KERNELS,
        compile_conf: Optional[Dict[str, str]] = None,
        session_manager=None,
        device: "torch.device | str" = "cuda",
    ):
        from ..lq.session import LEGACY_TENANT, SessionManager

        self.device = str(require_device(device))
        self.runtime = runtime_storage
        self.max_kernels = max_kernels
        # compile conf applied to every kernel (see Kernel.compile_conf)
        self.compile_conf = dict(compile_conf or {})
        self._tenant = LEGACY_TENANT
        self.sessions = session_manager or SessionManager(ttl_s=ttl_s)
        self.ttl_s = self.sessions.ttl_s

    # -- lifecycle -------------------------------------------------------
    def create_kernel(
        self,
        flow_name: str,
        schema_json: str,
        normalization: str = "Raw.*",
        sample_rows: Optional[List[dict]] = None,
        udfs: Optional[dict] = None,
        refdata_conf: Optional[Dict[str, str]] = None,
        debug: object = None,
    ) -> str:
        """Create + initialize a kernel; returns kernel id.

        Sample rows default to the flow's persisted sample blob
        (written by SchemaInferenceManager). ``debug`` asks for the
        ``process.debug`` guards, which the port refuses at the
        kernel's first execute."""
        if sample_rows is None:
            sample_rows = self._load_sample(flow_name)
        if not isinstance(schema_json, str):
            schema_json = json.dumps(schema_json)
        kernel = Kernel(
            id="",
            flow_name=flow_name,
            schema_json=schema_json,
            normalization=normalization,
            sample_rows=sample_rows or [],
            udfs=udfs,
            refdata_conf=refdata_conf or {},
            debug=debug,
            compile_conf=dict(self.compile_conf),
            device=self.device,
        )
        # legacy policy: evict the oldest-idle kernel when this
        # surface's cap is reached (the designer's recycle-oldest
        # behavior), instead of the serving plane's 429 rejection
        session = self.sessions.create(
            tenant=self._tenant,
            flow_name=flow_name,
            payload=kernel,
            evict_on_full=True,
            cap=self.max_kernels,
        )
        kernel.id = session.id
        return session.id

    def has_sample(self, flow_name: str) -> bool:
        """True when a persisted sample blob exists for the flow."""
        return (
            self.runtime is not None
            and bool(flow_name)
            and self.runtime.exists(self._sample_rel(flow_name))
        )

    @staticmethod
    def _sample_rel(flow_name: str) -> str:
        return f"{flow_name}/samples/sample.json"

    def _load_sample(self, flow_name: str) -> List[dict]:
        if not self.has_sample(flow_name):
            return []
        return [
            json.loads(ln)
            for ln in self.runtime.read_file(self._sample_rel(flow_name)).splitlines()
            if ln.strip()
        ]

    def get(self, kernel_id: str) -> Kernel:
        # the shared manager reaps expired sessions on every get — a
        # kernel left idle past its TTL is recycled here, not only when
        # the next create happens to run
        try:
            session = self.sessions.get(kernel_id)
        except KeyError:
            raise KeyError(f"kernel '{kernel_id}' not found (recycled?)")
        if session.tenant != self._tenant or session.payload is None:
            raise KeyError(f"kernel '{kernel_id}' not found (recycled?)")
        return session.payload

    def execute(
        self, kernel_id: str, query: str, max_rows: int = DEFAULT_MAX_ROWS
    ) -> dict:
        return self.get(kernel_id).execute(query, max_rows)

    def delete_kernel(self, kernel_id: str) -> bool:
        return self.sessions.close(kernel_id)

    def delete_kernels(self, flow_name: Optional[str] = None) -> int:
        """Recycle all kernels (optionally per flow)."""
        return self.sessions.close_where(
            flow_name=flow_name, tenant=self._tenant
        )

    def list_kernels(self) -> List[dict]:
        return [
            {
                "id": s.id,
                "flow": s.flow_name,
                "createdAt": s.created_at,
                "lastUsed": s.last_used,
                "sampleRows": len(s.payload.sample_rows)
                if s.payload is not None else 0,
            }
            for s in self.sessions.list(tenant=self._tenant)
        ]
