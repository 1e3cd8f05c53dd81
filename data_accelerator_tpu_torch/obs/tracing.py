"""Batch-granular span tracing for the streaming/batch engines.

Every micro-batch gets a ``trace_id``; every stage the host runs on its
behalf (decode -> dispatch -> device step -> completion sync -> collect
-> per-sink writes -> checkpoint) becomes a ``span`` record carrying
``span_id``/``parent_id``, start timestamp and duration. Spans are
emitted through the existing ``TelemetryWriter`` fan-out
(obs/telemetry.py), so the JSONL flight recorder doubles as a trace log
a CLI can reconstruct (one batch's span tree from its trace id).

reference: the AppInsights operation-correlation the reference gets for
free from DataX.Utilities.Telemetry (every ``streaming/batch/*`` event
shares an operation id); here the correlation is explicit and the store
is pluggable.

Design notes:
- Span boundaries are wall-clock host timestamps (``time.time`` for the
  epoch anchor, ``perf_counter`` for durations) — overhead is two clock
  reads and one dict per span; there is no per-row work.
- A thread-local *active trace* lets deep code (sinks, checkpointers,
  the processor's collect path) attach child spans without threading a
  context object through every signature: ``with tracing.span("x"):``
  is a no-op when no trace is active (e.g. bench.py driving the
  processor directly).
- Cross-thread stages (the pipelined decode-ahead worker) re-activate
  the batch's context explicitly via ``ctx.activate()``.
- Every finished span also feeds the per-stage latency histograms
  (obs/histogram.py) when the tracer holds a registry — spans and
  histograms cannot disagree because they share the one measurement.

Copy of the JAX package's ``obs/tracing.py``. The trace CLI is
``python -m data_accelerator_tpu_torch.obs trace`` (``obs/__main__.py``).
Added: while an on-demand ``torch.profiler`` capture runs
(``obs/profiler.py`` sets ``PROFILER_RANGES``), every child span also
opens a ``torch.profiler.record_function`` range of its name, so the
capture's timeline shows each thread's batch stages, the landing
thread's Python work among them, which runs few torch ops of its own.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import struct
import threading
import time
from typing import Dict, Iterator, Optional

import torch

from .histogram import HistogramRegistry

_local = threading.local()

# set while a profiler capture runs: spans then open profiler ranges
PROFILER_RANGES = threading.Event()

_trace_counter = itertools.count(1)


def _new_trace_id() -> str:
    """Unique, sortable-enough trace id: epoch-ms + 4 random bytes."""
    rnd = struct.unpack("<I", os.urandom(4))[0]
    return f"{int(time.time() * 1000):x}-{rnd:08x}"


def _span_prefix() -> str:
    """Random per-context span-id prefix, used when a context JOINS an
    existing trace (cross-process propagation): span ids are minted by
    a per-context counter, so two processes sharing one trace id need
    disjoint id spaces or their span ids collide."""
    return f"{struct.unpack('<I', os.urandom(4))[0]:08x}."


def format_parent(cap) -> Optional[str]:
    """Serialize a ``capture()`` as the ``<trace_id>:<span_id>`` string
    the ``datax.job.process.telemetry.parenttrace`` conf key carries
    across the process boundary (control plane -> spawned host)."""
    if cap is None:
        return None
    ctx, parent_id = cap
    return f"{ctx.trace_id}:{parent_id}"


def parse_parent(text: Optional[str]):
    """Inverse of ``format_parent``: ``(trace_id, span_id)`` or None."""
    if not text or ":" not in text:
        return None
    trace_id, _, span_id = text.rpartition(":")
    if not trace_id or not span_id:
        return None
    return trace_id, span_id


def current_trace() -> Optional["TraceContext"]:
    """The trace active on THIS thread (None outside any batch)."""
    stack = getattr(_local, "stack", None)
    return stack[-1][0] if stack else None


def capture():
    """Opaque (trace, parent-span) capture of this thread's active
    position, for handing to a worker thread (the sink fan-out runs one
    thread per output operator)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def activated(cap) -> Iterator[None]:
    """Re-activate a ``capture()`` on another thread; no-op for None."""
    if cap is None:
        yield
        return
    ctx, parent_id = cap
    with ctx.activate(parent_id=parent_id):
        yield


@contextlib.contextmanager
def span(name: str, **props) -> Iterator[Dict]:
    """Child span under the thread's active trace; no-op without one.

    Yields the span's props, so a value known only once the work is
    done (lines polled, bytes encoded) can join them before the span
    is emitted. The no-op path costs one attribute lookup — safe to
    leave in hot host code permanently (sinks, checkpoint, collect)."""
    stack = getattr(_local, "stack", None)
    if not stack:
        yield props
        return
    ctx, parent_id = stack[-1]
    with ctx._child(name, parent_id, props):
        yield props


class TraceContext:
    """One batch's trace: a root span plus explicitly-parented children.

    With ``trace_id``/``parent_span_id`` the context JOINS an existing
    (possibly remote) trace instead of minting one: the root span keeps
    a parent pointer into the foreign trace and every span id carries a
    random per-context prefix so concurrent contexts — other batches of
    the same job, other processes — cannot collide inside the shared
    trace."""

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        props: Dict,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
    ):
        self.tracer = tracer
        self.parent_span_id = parent_span_id
        if trace_id is not None:
            self.trace_id = trace_id
            prefix = _span_prefix()
        else:
            self.trace_id = _new_trace_id()
            prefix = ""
        self.root_span_id = prefix + "1"
        self._span_counter = (
            prefix + str(n) for n in itertools.count(2)
        )
        self._name = name
        self._props = dict(props)
        self._start_ts = time.time()
        self._start_pc = time.perf_counter()
        self._ended = False
        self._lock = threading.Lock()
        # named timestamps for spans whose endpoints are observed at
        # different call sites (e.g. device-step: dispatch return ->
        # completion sync)
        self.marks: Dict[str, tuple] = {}

    # -- root ------------------------------------------------------------
    def add(self, **props) -> None:
        """Attach properties to the root span (e.g. batchTime once the
        poll has determined it)."""
        self._props.update(props)

    def end(self, **props) -> None:
        """Close the root span (idempotent — a retry path may race the
        normal close)."""
        with self._lock:
            if self._ended:
                return
            self._ended = True
        self._props.update(props)
        self.tracer._emit_span(
            self, self._name, self.root_span_id, self.parent_span_id,
            self._start_ts, (time.perf_counter() - self._start_pc) * 1000.0,
            self._props,
        )

    # -- children --------------------------------------------------------
    @contextlib.contextmanager
    def activate(self, parent_id: Optional[str] = None) -> Iterator["TraceContext"]:
        """Install as the thread's active trace (children created via the
        module-level ``span()`` parent onto the root — or onto
        ``parent_id`` when re-activating a captured position — or the
        innermost open span of THIS thread)."""
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append((self, parent_id or self.root_span_id))
        try:
            yield self
        finally:
            stack.pop()

    @contextlib.contextmanager
    def span(self, name: str, **props) -> Iterator[None]:
        """Explicit child of the root — usable from any thread without
        activation (the pipelined loop holds several batches at once)."""
        with self._child(name, self.root_span_id, props):
            yield

    def mark(self, name: str) -> None:
        """Remember 'now' under ``name`` (see ``record_since``)."""
        self.marks[name] = (time.time(), time.perf_counter())

    def record_since(self, name: str, mark: str, **props) -> None:
        """Emit a span from a prior ``mark()`` to now (no-op when the
        mark was never set)."""
        m = self.marks.get(mark)
        if m is None:
            return
        self.record(
            name, m[0], (time.perf_counter() - m[1]) * 1000.0, **props
        )

    def record(self, name: str, start_ts: float, duration_ms: float,
               **props) -> None:
        """A span whose boundaries were measured externally (e.g. the
        device-step interval between dispatch return and completion
        sync, whose endpoints the host observed at different places)."""
        self.tracer._emit_span(
            self, name, str(next(self._span_counter)), self.root_span_id,
            start_ts, duration_ms, props,
        )

    @contextlib.contextmanager
    def _child(self, name: str, parent_id: str, props: Dict) -> Iterator[Dict]:
        span_id = str(next(self._span_counter))
        start_ts = time.time()
        t0 = time.perf_counter()
        stack = getattr(_local, "stack", None)
        pushed = False
        if stack is not None and stack and stack[-1][0] is self:
            # nest further children under this span on the same thread
            stack.append((self, span_id))
            pushed = True
        profiled = (
            torch.profiler.record_function(name) if PROFILER_RANGES.is_set()
            else contextlib.nullcontext()
        )
        try:
            with profiled:
                yield props
        finally:
            if pushed:
                stack.pop()
            self.tracer._emit_span(
                self, name, span_id, parent_id, start_ts,
                (time.perf_counter() - t0) * 1000.0, props,
            )


class Tracer:
    """Factory for per-batch traces, bound to a flow's telemetry fan-out
    and (optionally) the per-stage histogram registry.

    ``parent``: a ``<trace_id>:<span_id>`` string (the
    ``datax.job.process.telemetry.parenttrace`` conf value) — every
    trace this tracer begins then JOINS that trace instead of minting
    its own, so a spawned host's batch spans root in the control-plane
    request that launched the job."""

    def __init__(
        self,
        telemetry=None,
        histograms: Optional[HistogramRegistry] = None,
        flow: str = "",
        enabled: bool = True,
        parent: Optional[str] = None,
    ):
        self.telemetry = telemetry
        self.histograms = histograms
        self.flow = flow
        self.enabled = enabled
        self.parent = parse_parent(parent)

    def begin(self, name: str = "streaming/batch", **props) -> TraceContext:
        if self.parent is not None:
            return TraceContext(
                self, name, props,
                trace_id=self.parent[0], parent_span_id=self.parent[1],
            )
        return TraceContext(self, name, props)

    def _emit_span(
        self, ctx: TraceContext, name: str, span_id: str,
        parent_id: Optional[str], start_ts: float, duration_ms: float,
        props: Dict,
    ) -> None:
        # histograms always observe (they are the live latency source
        # even when span emission is turned off); the root span's
        # "streaming/" prefix is stripped so its stage is "batch"
        if self.histograms is not None:
            stage = name[10:] if name.startswith("streaming/") else name
            # the span's trace id rides along as the histogram exemplar
            # (a latency spike links back to the batch that caused it)
            self.histograms.observe(
                self.flow, stage, duration_ms, trace_id=ctx.trace_id
            )
        if not self.enabled or self.telemetry is None:
            return
        self.telemetry.track_span(
            name,
            trace_id=ctx.trace_id,
            span_id=span_id,
            parent_id=parent_id,
            start_ts=start_ts,
            duration_ms=duration_ms,
            properties=props,
        )
