"""Micro-batched device dispatch for concurrent LiveQuery sessions.

The serving plane's throughput lever: incoming ``execute()`` calls
queue PER COMPILE SIGNATURE (flow-hash x pow2 row bucket x query
shape — ``warmcache.signature_for``), and a scheduling tick fires each
signature's queue as ONE dispatch group against that signature's single
resident kernel. Calls whose payload is identical (same rows digest,
query, max_rows — the many-users-one-dashboard case) share literally
one device dispatch and one result object; calls with distinct rows in
the same signature share the COMPILED entry (their rows pad into the
same pow2 bucket, so the trace is reused — no recompile, the jit-cache
surface stays bounded by the lattice while QPS scales with tenants).

Ticks are deadline-based: a queue fires when its oldest call has
waited ``max_wait_ms`` (conf ``datax.job.process.lq.maxbatchwaitms``)
or when it reaches ``max_fanin`` calls — so a loaded service amortizes
dispatches across tenants, and an idle one still answers a lone
interactive user within one deadline. A kernel failure mid-tick fails
ONLY the calls of the payload that raised; other payloads in the group
still resolve, and the next tick retries fresh (the compiled entry is
dropped so a poisoned trace cannot wedge the signature).

A whole copy of the JAX package's ``lq/coalescer.py``; its relative
imports reach the port's ``lq/warmcache.py``. In the port a "trace" is
a processor's step, and the jit cache is what
``FlowProcessor._step_cache_size`` counts. ``_run_group`` runs under
``_run_lock``, which is what makes ``WarmKernel.execute``'s re-pointing
of a kernel's rows safe.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .warmcache import (
    CompileSignature,
    WarmKernelCache,
    rows_digest,
    signature_for,
)

DEFAULT_MAX_WAIT_MS = 8.0
DEFAULT_MAX_FANIN = 64
DEFAULT_EXEC_TIMEOUT_S = 30.0


class ExecCancelled(RuntimeError):
    """The queued call's session went away before its tick fired."""


class PendingExec:
    """One queued execute: callers block on ``wait``; the tick runner
    resolves or fails it."""

    def __init__(self, session_id: str, tenant: str, query: str,
                 max_rows: int, rows: List[dict], enqueued_at: float):
        self.session_id = session_id
        self.tenant = tenant
        self.query = query
        self.max_rows = int(max_rows)
        self.rows = rows
        self.rows_key = rows_digest(rows)
        self.enqueued_at = enqueued_at
        self._event = threading.Event()
        self._result: Optional[dict] = None
        self._exc: Optional[BaseException] = None

    @property
    def payload_key(self) -> Tuple[str, str, int]:
        return (self.rows_key, self.query, self.max_rows)

    def resolve(self, result: dict) -> None:
        self._result = result
        self._event.set()

    def fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout_s: float = DEFAULT_EXEC_TIMEOUT_S) -> dict:
        if not self._event.wait(timeout_s):
            raise TimeoutError(
                f"LiveQuery execute timed out after {timeout_s:g}s "
                "(dispatch tick never fired?)"
            )
        if self._exc is not None:
            raise self._exc
        return self._result  # type: ignore[return-value]


class DispatchCoalescer:
    """Per-signature queues + the deadline tick that drains them."""

    def __init__(
        self,
        cache: WarmKernelCache,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
        max_fanin: int = DEFAULT_MAX_FANIN,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        self.cache = cache
        self.max_wait_ms = float(max_wait_ms)
        self.max_fanin = int(max_fanin)
        self.now = now_fn
        self._queues: Dict[str, Tuple[CompileSignature, List[PendingExec]]] = {}
        self._sessions_of_queue: Dict[str, object] = {}
        self._lock = threading.Lock()
        # serializes tick execution: one group runs at a time, so the
        # shared kernels' row re-pointing is single-threaded
        self._run_lock = threading.Lock()
        # cumulative counters (service exports them as LQ_* series)
        self.ticks = 0
        self.calls = 0
        self.dispatches = 0
        self.failed_dispatches = 0
        self.last_fanin = 0
        self.max_fanin_seen = 0

    # -- intake -----------------------------------------------------------
    def submit(self, session, query: str, max_rows: int = 100) -> PendingExec:
        """Queue one execute under its compile signature; returns the
        pending handle the caller blocks on. Quota admission happens
        BEFORE this (``SessionManager.admit_execute``) — a rejected
        call never reaches a queue, so it can never consume a
        dispatch."""
        sig = signature_for(session, query, self.cache.compile_conf)
        call = PendingExec(
            session.id, session.tenant, query, max_rows,
            list(session.sample_rows), self.now(),
        )
        with self._lock:
            entry = self._queues.get(sig.key)
            if entry is None:
                entry = self._queues[sig.key] = (sig, [])
                # the first queued session is the template the cache
                # builds the signature's kernel from on miss
                self._sessions_of_queue[sig.key] = session
            entry[1].append(call)
            self.calls += 1
        return call

    def cancel_session(self, session_id: str) -> int:
        """Fail every queued call of a reaped/closed session (its tick
        has not fired yet, so no device work is lost)."""
        cancelled = 0
        with self._lock:
            for sig_key in list(self._queues):
                sig, calls = self._queues[sig_key]
                keep = []
                for c in calls:
                    if c.session_id == session_id:
                        c.fail(ExecCancelled(
                            f"session '{session_id}' closed before its "
                            "dispatch tick fired"
                        ))
                        cancelled += 1
                    else:
                        keep.append(c)
                if keep:
                    self._queues[sig_key] = (sig, keep)
                else:
                    del self._queues[sig_key]
                    self._sessions_of_queue.pop(sig_key, None)
        return cancelled

    # -- scheduling -------------------------------------------------------
    def backlog(self) -> int:
        """Queued, not-yet-dispatched calls — the pilot-visible
        pressure signal (``LQ_Backlog``)."""
        with self._lock:
            return sum(len(calls) for _, calls in self._queues.values())

    def _due_locked(self, now: float, force: bool) -> List[str]:
        due = []
        for sig_key, (_, calls) in self._queues.items():
            if not calls:
                continue
            age_ms = (now - calls[0].enqueued_at) * 1000.0
            if force or age_ms >= self.max_wait_ms \
                    or len(calls) >= self.max_fanin:
                due.append(sig_key)
        return due

    def run_due(self, now: Optional[float] = None, force: bool = False) -> int:
        """Run one scheduling tick: every signature queue past its
        deadline (all of them when ``force``) fires as one dispatch
        group. Returns the number of groups run."""
        now = self.now() if now is None else now
        with self._lock:
            due = self._due_locked(now, force)
            groups = []
            for sig_key in due:
                sig, calls = self._queues.pop(sig_key)
                template = self._sessions_of_queue.pop(sig_key)
                groups.append((sig, template, calls))
        for sig, template, calls in groups:
            self._run_group(sig, template, calls)
        return len(groups)

    def flush(self) -> int:
        """Fire every queue now — the no-ticker (synchronous) mode and
        the test harness's determinism hook."""
        return self.run_due(force=True)

    # -- execution --------------------------------------------------------
    def _run_group(self, sig: CompileSignature, template,
                   calls: List[PendingExec]) -> None:
        with self._run_lock:
            self.ticks += 1
            self.last_fanin = len(calls)
            self.max_fanin_seen = max(self.max_fanin_seen, len(calls))
            try:
                entry = self.cache.acquire(sig, template)
            except Exception as e:  # noqa: BLE001 — building the kernel failed
                for c in calls:
                    c.fail(e)
                self.failed_dispatches += 1
                return
            # one dispatch per DISTINCT payload; identical payloads
            # (the dominant shared-dashboard case) share one result
            by_payload: Dict[Tuple[str, str, int], List[PendingExec]] = {}
            for c in calls:
                by_payload.setdefault(c.payload_key, []).append(c)
            poisoned = False
            for payload_calls in by_payload.values():
                first = payload_calls[0]
                try:
                    result = entry.execute(
                        first.rows, first.query, first.max_rows
                    )
                    self.dispatches += 1
                except Exception as e:  # noqa: BLE001 — per-payload isolation
                    self.failed_dispatches += 1
                    poisoned = True
                    for c in payload_calls:
                        c.fail(e)
                    continue
                for c in payload_calls:
                    c.resolve(result)
            if poisoned:
                # a trace that raised mid-tick cannot be trusted to
                # serve the next tick — drop the entry; the next
                # acquire re-warms through the persistent compile cache
                with self.cache._lock:
                    self.cache._entries.pop(sig.key, None)
            self.cache.settle(in_use=None if poisoned else entry)

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            backlog = sum(len(calls) for _, calls in self._queues.values())
        return {
            "ticks": self.ticks,
            "calls": self.calls,
            "dispatches": self.dispatches,
            "failedDispatches": self.failed_dispatches,
            "coalesced": max(0, self.calls - self.dispatches),
            "backlog": backlog,
            "lastFanin": self.last_fanin,
            "maxFaninSeen": self.max_fanin_seen,
            "avgFanin": round(self.calls / self.ticks, 3) if self.ticks else 0.0,
        }
