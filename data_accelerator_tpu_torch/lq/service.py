"""LiveQueryService: the multi-tenant interactive serving plane.

Composes the three serving-plane parts into the one object the REST
surface talks to:

- ``SessionManager`` — tenant registry, TTL reaping, quota admission
  (typed rejections the REST layer maps to 429 + ``Retry-After``);
- ``WarmKernelCache`` — signature-keyed resident kernels under a
  device-byte budget (``FlowProcessor.device_bytes``);
- ``DispatchCoalescer`` — per-signature micro-batching with deadline
  ticks (``lq.maxbatchwaitms``).

Conf block (``datax.job.process.lq.*``, designer ``jobLq*`` knobs via
generation S400/S650):

==========================  =======  =====================================
key                         default  meaning
==========================  =======  =====================================
``maxbatchwaitms``          8        dispatch tick deadline per signature
``maxfanin``                64       calls that force a tick early
``sessionttlseconds``       1800     idle session TTL (both surfaces)
``maxsessions``             1024     service-wide session cap
``tenant.maxsessions``      8        per-tenant concurrent session quota
``tenant.maxqps``           50       per-tenant execute QPS quota
``hbmbudgetmb``             (model)  warm-kernel residency budget; the
                                     default is ``costmodel.warm_kernel_
                                     cache_budget_bytes()`` (25% of the
                                     device's memory)
``exectimeoutseconds``      30       caller wait bound per execute
``ticker``                  auto     background tick thread; when off,
                                     every execute flushes its own tick
                                     (the synchronous one-box mode)
==========================  =======  =====================================

Observability: ``LQ_*`` gauges/counters + the ``Latency-LQExec-pNN``
histogram series (exemplar-bearing, like every other latency family),
under the JAX package's names (documented in OBSERVABILITY.md,
"LiveQuery serving metrics"). ``LQ_Backlog`` is the pilot-visible
pressure signal, and the default ``lq-latency-slo`` alert rule
(obs/alerts.py) votes ``backpressure`` while p99 exec latency is over
SLO — one action vocabulary with the autopilot.

A copy of the JAX package's ``lq/service.py`` with these changes: the
service takes ``device`` (``"cuda"`` by default; raises without a card)
and passes it to its ``WarmKernelCache``; the reap hook holds the
coalescer's method, not the service, so nothing the service owns refers
back to it; ``stop`` also drops the resident kernels, so a stopped
service gives back its device memory.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from ..obs.histogram import HistogramRegistry
from ..obs.metrics import MetricLogger
from .coalescer import DEFAULT_EXEC_TIMEOUT_S, DispatchCoalescer
from .session import AdmissionRejected, SessionManager
from .warmcache import WarmKernelCache

LQ_FLOW = "LiveQuery"
LQ_APP = "DATAX-LiveQuery"
#: histogram stage of one end-to-end execute (queue wait + dispatch) —
#: a member of ``constants.MetricName.STAGES`` so alert rules resolve
#: ``Latency-LQExec-pNN`` through the live histogram like any stage
LQ_EXEC_STAGE = "lq-exec"

_CONF_PREFIX = "datax.job.process.lq."


def _conf_get(conf, key: str, default):
    """Read ``datax.job.process.lq.<key>`` from a SettingDictionary, a
    flat conf dict, or a bare {key: value} dict."""
    if conf is None:
        return default
    getter = getattr(conf, "get", None)
    if getter is None:
        return default
    v = getter(_CONF_PREFIX + key)
    if v is None:
        v = getter(key)
    if v in (None, ""):
        return default
    if isinstance(default, bool):
        return str(v).lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(float(v))
    if isinstance(default, float):
        return float(v)
    return v


class LiveQueryService:
    """The serving plane facade: session lifecycle + coalesced execute
    + the LQ_* observability surface."""

    def __init__(
        self,
        conf=None,
        session_manager: Optional[SessionManager] = None,
        compile_conf: Optional[Dict[str, str]] = None,
        store=None,
        now_fn=time.time,
        ticker: Optional[bool] = None,
        device: "torch.device | str" = "cuda",
    ):
        self.max_wait_ms = _conf_get(conf, "maxbatchwaitms", 8.0)
        self.max_fanin = _conf_get(conf, "maxfanin", 64)
        self.exec_timeout_s = _conf_get(
            conf, "exectimeoutseconds", DEFAULT_EXEC_TIMEOUT_S
        )
        ttl_s = _conf_get(conf, "sessionttlseconds", 1800.0)
        budget_mb = _conf_get(conf, "hbmbudgetmb", 0)
        self.sessions = session_manager or SessionManager(
            ttl_s=ttl_s,
            max_sessions=_conf_get(conf, "maxsessions", 1024),
            tenant_max_sessions=_conf_get(conf, "tenant.maxsessions", 8),
            tenant_max_qps=_conf_get(conf, "tenant.maxqps", 50.0),
            now_fn=now_fn,
        )
        self.cache = WarmKernelCache(
            budget_bytes=int(budget_mb) * 1024 * 1024 if budget_mb else None,
            compile_conf=compile_conf,
            now_fn=now_fn,
            device=device,
        )
        self.coalescer = DispatchCoalescer(
            self.cache,
            max_wait_ms=self.max_wait_ms,
            max_fanin=self.max_fanin,
        )
        # a closed/reaped session's queued calls fail fast instead of
        # waiting out the exec timeout; the hook holds the coalescer's
        # method, not the service, so the service is in no cycle
        cancel = self.coalescer.cancel_session
        self.sessions.on_reap(lambda s: cancel(s.id))
        self.histograms = HistogramRegistry()
        self.metrics = MetricLogger(LQ_APP, store=store)
        # boot-time conf audit (runtime/confaudit.py): a full prefixed
        # conf handed to the service is replayed through the DX10xx
        # lattice validator — DX1006 flight records + Conf_* gauges for
        # unknown/out-of-bounds keys. Bare {key: value} dicts (the
        # test-convenience form) carry no datax.job.process.* keys and
        # audit as empty. Advisory: never blocks boot.
        from ..runtime.confaudit import from_conf as _confaudit_from_conf

        self.conf_audit = _confaudit_from_conf(
            conf, subject="lq", metric_logger=self.metrics
        )
        self._qps_window: List[float] = []  # completion stamps (10 s)
        self._qps_lock = threading.Lock()
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        want_ticker = _conf_get(conf, "ticker", bool(ticker))
        if want_ticker:
            self.start_ticker()

    # -- ticker -----------------------------------------------------------
    @property
    def ticking(self) -> bool:
        return self._ticker is not None and self._ticker.is_alive()

    def start_ticker(self) -> None:
        """Run deadline ticks on a background thread — the serving
        mode: REST threads enqueue and block; this thread dispatches."""
        if self.ticking:
            return
        self._ticker_stop.clear()

        def loop():
            interval = max(0.001, self.max_wait_ms / 2000.0)
            while not self._ticker_stop.wait(interval):
                try:
                    self.coalescer.run_due()
                except Exception:  # noqa: BLE001 — tick must never die
                    pass

        self._ticker = threading.Thread(
            target=loop, name="lq-ticker", daemon=True
        )
        self._ticker.start()

    def stop_ticker(self) -> None:
        self._ticker_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=2.0)
            self._ticker = None

    # -- session lifecycle ------------------------------------------------
    def create_session(
        self,
        tenant: str,
        flow_name: str,
        schema_json: str,
        normalization: str = "Raw.*",
        sample_rows: Optional[List[dict]] = None,
        udfs: Optional[dict] = None,
        refdata_conf: Optional[Dict[str, str]] = None,
        debug: object = None,
    ) -> dict:
        s = self.sessions.create(
            tenant=tenant or "default",
            flow_name=flow_name,
            schema_json=schema_json,
            normalization=normalization,
            sample_rows=sample_rows,
            udfs=udfs,
            refdata_conf=refdata_conf,
            debug=debug,
        )
        return s.to_dict()

    def close_session(self, session_id: str) -> bool:
        self.coalescer.cancel_session(session_id)
        return self.sessions.close(session_id)

    def close_flow(self, flow_name: str) -> int:
        n = self.sessions.close_where(flow_name=flow_name)
        self.cache.evict_flow(flow_name)
        return n

    def list_sessions(self, tenant: Optional[str] = None) -> List[dict]:
        return [s.to_dict() for s in self.sessions.list(tenant=tenant)]

    # -- execute ----------------------------------------------------------
    def execute(self, session_id: str, query: str,
                max_rows: int = 100) -> dict:
        """One tenant execute through the serving plane: quota
        admission (typed reject, NO dispatch), coalescer enqueue, tick
        (background when the ticker runs, inline flush otherwise),
        result. Latency lands in the ``lq-exec`` histogram with the
        session id as exemplar."""
        t0 = time.monotonic()
        session = self.sessions.get(session_id)
        # admission BEFORE the coalescer ever sees the call: a rejected
        # tenant consumes zero queue slots and zero device dispatches
        self.sessions.admit_execute(session)
        pending = self.coalescer.submit(session, query, max_rows=max_rows)
        if not self.ticking:
            self.coalescer.flush()
        try:
            result = pending.wait(self.exec_timeout_s)
        finally:
            ms = (time.monotonic() - t0) * 1000.0
            self.histograms.observe(
                LQ_FLOW, LQ_EXEC_STAGE, ms, trace_id=session_id
            )
        with self._qps_lock:
            now = time.monotonic()
            self._qps_window.append(now)
            cutoff = now - 10.0
            while self._qps_window and self._qps_window[0] < cutoff:
                self._qps_window.pop(0)
        return result

    # -- observability ----------------------------------------------------
    def qps(self) -> float:
        with self._qps_lock:
            if len(self._qps_window) < 2:
                return float(len(self._qps_window))
            span = self._qps_window[-1] - self._qps_window[0]
            return (
                len(self._qps_window) / span if span > 0
                else float(len(self._qps_window))
            )

    def lq_metrics(self) -> Dict[str, float]:
        """The LQ_* gauge/counter snapshot plus the exec-latency
        percentiles, under the JAX package's registered names."""
        sess = self.sessions.stats()
        cache = self.cache.stats()
        co = self.coalescer.stats()
        m = {
            "LQ_Sessions": float(sess["sessions"]),
            "LQ_Tenants": float(sess["tenants"]),
            "LQ_Qps": round(self.qps(), 3),
            "LQ_Backlog": float(co["backlog"]),
            "LQ_CoalesceFanin": float(co["avgFanin"]),
            "LQ_Dispatch_Count": float(co["dispatches"]),
            "LQ_Coalesced_Count": float(co["coalesced"]),
            "LQ_KernelBytes": float(cache["residentBytes"]),
            "LQ_KernelEvict_Count": float(cache["evictions"]),
            "LQ_Admission_Rejected_Count": float(sess["rejectedTotal"]),
        }
        for q in (50, 95, 99):
            v = self.histograms.percentile(LQ_FLOW, LQ_EXEC_STAGE, q)
            if v is not None:
                m[f"Latency-LQExec-p{q}"] = v
        return m

    def export_metrics(self) -> Dict[str, float]:
        """Push the LQ_* snapshot to the metric store (the same
        store/exposition path every engine series rides)."""
        m = self.lq_metrics()
        self.metrics.send_batch_metrics(m)
        return m

    def snapshot(self) -> dict:
        """The ``GET lq/stats`` payload: metrics + component detail."""
        return {
            "metrics": self.export_metrics(),
            "sessions": self.sessions.stats(),
            "cache": self.cache.stats(),
            "coalescer": self.coalescer.stats(),
            "maxBatchWaitMs": self.max_wait_ms,
            "ticking": self.ticking,
        }

    def stop(self) -> None:
        """Stop the ticker and drop the resident kernels."""
        self.stop_ticker()
        self.cache.clear()


__all__ = [
    "AdmissionRejected",
    "LiveQueryService",
    "LQ_EXEC_STAGE",
    "LQ_FLOW",
]
