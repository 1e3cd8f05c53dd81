"""Multi-tenant session registry for the LiveQuery serving plane.

reference: the reference platform's InteractiveQueryService tracks one
kernel list per cluster with a recycle timer (KernelService.cs:135-190)
and relies on the designer to be the only tenant; a serving plane that
multiplexes "as many users as you can imagine" (ROADMAP item 3) needs
the registry to be the admission point instead: per-tenant session and
QPS quotas enforced BEFORE any device work is queued, typed rejections
the REST surface can turn into 429 + Retry-After, and TTL/idle reaping
on every access path so abandoned sessions can never pin kernels.

One registry serves BOTH surfaces: the new ``lq/`` session service and
the legacy ``serve/livequery.py`` ``KernelService`` (whose REST-created
kernels previously leaked — GC only ran inside ``create_kernel``, so a
designer that stopped creating kernels kept every old one alive
forever). The legacy surface registers its kernels under the
``LEGACY_TENANT`` with the evict-oldest-on-full policy it always had;
the serving plane registers real tenants with the reject-with-429
policy a multi-tenant admission gate needs. Quota state is per tenant,
session records are one flat dict — ``delete per flow`` and ``reap``
see both surfaces.

A whole copy of the JAX package's ``lq/session.py``: it is
framework-free.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

DEFAULT_SESSION_TTL_S = 30 * 60
DEFAULT_MAX_SESSIONS = 1024
DEFAULT_TENANT_MAX_SESSIONS = 8
DEFAULT_TENANT_MAX_QPS = 50.0

#: the tenant the legacy ``KernelService`` registers kernels under —
#: exempt from per-tenant quotas (the designer was never quota'd) but
#: fully subject to TTL reaping and its own capacity policy.
LEGACY_TENANT = "__legacy__"

#: typed rejection kinds — the contract between admission, the
#: ``LQ_Admission_Rejected_Count`` counter and the REST 429 body.
REJECT_TENANT_SESSIONS = "tenant-sessions"
REJECT_SERVICE_SESSIONS = "service-sessions"
REJECT_TENANT_QPS = "tenant-qps"
REJECT_KINDS = (
    REJECT_TENANT_SESSIONS, REJECT_SERVICE_SESSIONS, REJECT_TENANT_QPS,
)


class AdmissionRejected(Exception):
    """A session/execute was refused at admission — BEFORE any kernel
    compile or device dispatch was queued. ``kind`` is one of
    ``REJECT_KINDS``; ``retry_after_s`` is the hint the REST surface
    sends as ``Retry-After``."""

    def __init__(self, kind: str, message: str, tenant: str = "",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.kind = kind
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)

    def to_dict(self) -> dict:
        return {
            "message": str(self),
            "kind": self.kind,
            "tenant": self.tenant,
            "retryAfterSeconds": round(self.retry_after_s, 3),
        }


class QuotaBucket:
    """Strict per-tenant QPS token bucket.

    Unlike the pilot's source-backpressure ``TokenBucket`` (which
    always grants >= 1 so a throttled flow can observe its own drain),
    a quota bucket must be able to say NO: an over-quota tenant's
    execute is rejected outright and told when to come back."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.rate = max(float(rate), 0.001)
        self.burst = float(burst) if burst is not None else max(
            1.0, self.rate
        )
        self.now = now_fn
        self._tokens = self.burst
        self._last = self.now()

    def _refill(self) -> None:
        now = self.now()
        self._tokens = min(
            self.burst, self._tokens + max(0.0, now - self._last) * self.rate
        )
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available."""
        self._refill()
        missing = max(0.0, n - self._tokens)
        return missing / self.rate


@dataclass
class Session:
    """One tenant's interactive session: the flow-scoped inputs a
    kernel needs, but NO compiled state — compiled kernels live in the
    signature-keyed ``WarmKernelCache`` so the compile surface is
    bounded by the bucket lattice, not by session count."""

    id: str
    tenant: str
    flow_name: str
    schema_json: str = ""
    normalization: str = "Raw.*"
    sample_rows: List[dict] = field(default_factory=list)
    udfs: Optional[dict] = None
    refdata_conf: Dict[str, str] = field(default_factory=dict)
    debug: object = None
    created_at: float = 0.0
    last_used: float = 0.0
    executes: int = 0
    #: legacy surface parks its compiled Kernel object here
    payload: object = None

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "tenant": self.tenant,
            "flow": self.flow_name,
            "createdAt": self.created_at,
            "lastUsed": self.last_used,
            "executes": self.executes,
            "sampleRows": len(self.sample_rows),
        }


class _TenantState:
    def __init__(self, bucket: Optional[QuotaBucket]):
        self.bucket = bucket
        self.sessions = 0


class SessionManager:
    """Per-tenant session registry with TTL/idle reaping and quota
    admission. Thread-safe; every mutation reaps expired sessions
    first, so TTL eviction happens on EVERY access path (create,
    get, execute-admit, list) — the legacy leak is structurally gone."""

    def __init__(
        self,
        ttl_s: float = DEFAULT_SESSION_TTL_S,
        max_sessions: int = DEFAULT_MAX_SESSIONS,
        tenant_max_sessions: int = DEFAULT_TENANT_MAX_SESSIONS,
        tenant_max_qps: float = DEFAULT_TENANT_MAX_QPS,
        now_fn: Callable[[], float] = time.time,
    ):
        self.ttl_s = float(ttl_s)
        self.max_sessions = int(max_sessions)
        self.tenant_max_sessions = int(tenant_max_sessions)
        self.tenant_max_qps = float(tenant_max_qps)
        self.now = now_fn
        self._sessions: Dict[str, Session] = {}
        self._tenants: Dict[str, _TenantState] = {}
        self._lock = threading.RLock()
        self._reaped_total = 0
        self._rejected: Dict[str, int] = {k: 0 for k in REJECT_KINDS}
        # reap hooks: the serving plane subscribes so a reaped session's
        # queued work can be failed instead of orphaned
        self._on_reap: List[Callable[[Session], None]] = []

    # -- internals --------------------------------------------------------
    def _tenant(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            bucket = (
                None if tenant == LEGACY_TENANT
                else QuotaBucket(self.tenant_max_qps)
            )
            st = self._tenants[tenant] = _TenantState(bucket)
        return st

    def _drop_locked(self, sid: str, reaped: bool = False) -> Optional[Session]:
        s = self._sessions.pop(sid, None)
        if s is None:
            return None
        st = self._tenants.get(s.tenant)
        if st is not None:
            st.sessions = max(0, st.sessions - 1)
            if st.sessions == 0 and s.tenant != LEGACY_TENANT:
                # forget idle tenants so quota state can't grow forever
                del self._tenants[s.tenant]
        if reaped:
            self._reaped_total += 1
        return s

    def _reap_locked(self) -> List[Session]:
        now = self.now()
        doomed = [
            sid for sid, s in self._sessions.items()
            if now - s.last_used > self.ttl_s
        ]
        return [self._drop_locked(sid, reaped=True) for sid in doomed]

    def _notify_reaped(self, reaped: List[Session]) -> None:
        for s in reaped:
            for hook in self._on_reap:
                try:
                    hook(s)
                except Exception:  # noqa: BLE001 — hooks must not gate GC
                    pass

    def on_reap(self, hook: Callable[[Session], None]) -> None:
        self._on_reap.append(hook)

    def _reject(self, kind: str, message: str, tenant: str,
                retry_after_s: float) -> AdmissionRejected:
        self._rejected[kind] = self._rejected.get(kind, 0) + 1
        return AdmissionRejected(
            kind, message, tenant=tenant, retry_after_s=retry_after_s
        )

    # -- lifecycle --------------------------------------------------------
    def create(
        self,
        tenant: str,
        flow_name: str,
        schema_json: str = "",
        normalization: str = "Raw.*",
        sample_rows: Optional[List[dict]] = None,
        udfs: Optional[dict] = None,
        refdata_conf: Optional[Dict[str, str]] = None,
        debug: object = None,
        payload: object = None,
        evict_on_full: bool = False,
        cap: Optional[int] = None,
    ) -> Session:
        """Admit + register a session. ``evict_on_full``/``cap`` are the
        legacy surface's policy (evict the oldest-idle kernel instead of
        rejecting, against its own ``max_kernels`` cap); the serving
        plane leaves them unset and gets typed 429-able rejections."""
        with self._lock:
            reaped = self._reap_locked()
            st = self._tenant(tenant)
            service_cap = int(cap) if cap is not None else self.max_sessions
            pool = (
                st.sessions if cap is not None
                else len(self._sessions)
            )
            if pool >= service_cap:
                if evict_on_full:
                    candidates = [
                        s for s in self._sessions.values()
                        if cap is None or s.tenant == tenant
                    ]
                    while pool >= service_cap and candidates:
                        oldest = min(candidates, key=lambda s: s.last_used)
                        candidates.remove(oldest)
                        self._drop_locked(oldest.id)
                        pool -= 1
                else:
                    raise self._reject(
                        REJECT_SERVICE_SESSIONS,
                        f"service session capacity {service_cap} reached",
                        tenant, retry_after_s=min(self.ttl_s, 30.0),
                    )
            if tenant != LEGACY_TENANT \
                    and st.sessions >= self.tenant_max_sessions:
                raise self._reject(
                    REJECT_TENANT_SESSIONS,
                    f"tenant '{tenant}' session quota "
                    f"{self.tenant_max_sessions} reached",
                    tenant, retry_after_s=min(self.ttl_s, 30.0),
                )
            now = self.now()
            s = Session(
                id=uuid.uuid4().hex[:12],
                tenant=tenant,
                flow_name=flow_name,
                schema_json=schema_json,
                normalization=normalization,
                sample_rows=list(sample_rows or []),
                udfs=udfs,
                refdata_conf=dict(refdata_conf or {}),
                debug=debug,
                created_at=now,
                last_used=now,
                payload=payload,
            )
            self._sessions[s.id] = s
            st.sessions += 1
        self._notify_reaped(reaped)
        return s

    def get(self, session_id: str, touch: bool = True) -> Session:
        with self._lock:
            reaped = self._reap_locked()
            s = self._sessions.get(session_id)
            if s is not None and touch:
                s.last_used = self.now()
        self._notify_reaped(reaped)
        if s is None:
            raise KeyError(
                f"session '{session_id}' not found (expired or closed?)"
            )
        return s

    def admit_execute(self, session: Session) -> None:
        """Per-tenant QPS admission for one execute; raises the typed
        rejection BEFORE the call reaches the coalescer (a quota'd
        tenant never consumes a device dispatch)."""
        with self._lock:
            st = self._tenant(session.tenant)
            if st.bucket is not None and not st.bucket.try_take(1.0):
                raise self._reject(
                    REJECT_TENANT_QPS,
                    f"tenant '{session.tenant}' over "
                    f"{self.tenant_max_qps:g} qps quota",
                    session.tenant,
                    retry_after_s=max(0.02, st.bucket.retry_after_s(1.0)),
                )
            session.last_used = self.now()
            session.executes += 1

    def close(self, session_id: str) -> bool:
        with self._lock:
            return self._drop_locked(session_id) is not None

    def close_where(self, flow_name: Optional[str] = None,
                    tenant: Optional[str] = None) -> int:
        with self._lock:
            doomed = [
                sid for sid, s in self._sessions.items()
                if (flow_name is None or s.flow_name == flow_name)
                and (tenant is None or s.tenant == tenant)
            ]
            for sid in doomed:
                self._drop_locked(sid)
            return len(doomed)

    def reap(self) -> int:
        with self._lock:
            reaped = self._reap_locked()
        self._notify_reaped(reaped)
        return len(reaped)

    def list(self, tenant: Optional[str] = None,
             exclude_tenant: Optional[str] = None) -> List[Session]:
        with self._lock:
            reaped = self._reap_locked()
            out = [
                s for s in self._sessions.values()
                if (tenant is None or s.tenant == tenant)
                and (exclude_tenant is None or s.tenant != exclude_tenant)
            ]
        self._notify_reaped(reaped)
        return out

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            tenants = {
                t for t, st in self._tenants.items()
                if st.sessions > 0 and t != LEGACY_TENANT
            }
            return {
                "sessions": len(self._sessions),
                "tenants": len(tenants),
                "reaped": self._reaped_total,
                "rejected": dict(self._rejected),
                "rejectedTotal": sum(self._rejected.values()),
            }
