"""Chaos fault injectors for the runtime's recovery + pilot proofs.

reference: the reference platform's only standing fault drill is the
scheduled probe scenario suite (Services/JobRunner re-running
SaveAndDeploy against production); faults themselves — preempted
cluster jobs, throttled sinks, poisoned streams — were discovered in
production and handled by operators (SURVEY §1). This module packages
those faults as first-class injectors so the scenario suite
(serve/scenarios.py ``chaos_*``) and tier-1 tests can assert BOTH
invariants ROADMAP item 5 demands:

- **baseline survives**: with the pilot disabled, every fault ends in
  checkpointed exactly-once-per-window recovery (the fsync'd
  checkpointers + whole-window requeue machinery);
- **pilot reacts**: with the pilot enabled, the fault's signal drives
  the expected actuation (depth drops under stall, backpressure
  engages under sink outage / malformed flood, replicas scale under
  sustained lag) and every actuation lands as a ``pilot/decide`` span.

Injectors arm against a live ``StreamingHost`` (wrapping one seam
each) and restore it on ``disarm()``; payload helpers synthesize the
skewed / malformed event streams. Nothing here imports test
frameworks — the injectors are runtime objects a production drill
could arm too.

Copy of the JAX package's ``pilot/chaos.py``. It arms against the
port's ``StreamingHost`` through the same seams
(``processor.dispatch_batch``, the dispatcher's sinks) and imports only
ported modules (``compile/aotcache.py::_parse_objstore_url``,
``serve/objectstore.py``). The scenario suite that arms it
(``serve/scenarios.py``) comes with slice 9b.
"""

from __future__ import annotations

import json
import random
import time
from typing import List, Optional


class ChaosFault(RuntimeError):
    """Raised by injectors that kill work mid-flight (the preemption
    SIGKILL stand-in) — distinguishable from real engine errors."""


class Injector:
    """One fault, armed against one host. ``arm`` wraps the target
    seam; ``disarm`` restores it (idempotent)."""

    name = "injector"

    def arm(self, host) -> None:
        raise NotImplementedError

    def disarm(self) -> None:
        raise NotImplementedError


class PreemptionInjector(Injector):
    """Kill the job mid-window: the Nth dispatch raises ``ChaosFault``
    with earlier batches still in flight — the in-process analog of a
    machine preemption / k8s node drain SIGKILLing the host while the
    window holds un-acked batches. Recovery = a fresh host over the
    same checkpoint dir + requeued source."""

    name = "preemption"

    def __init__(self, kill_at_dispatch: int = 3):
        self.kill_at_dispatch = kill_at_dispatch
        self._host = None
        self._real = None
        self.dispatches = 0

    def arm(self, host) -> None:
        self._host = host
        self._real = host.processor.dispatch_batch

        def dispatch(*a, **kw):
            self.dispatches += 1
            if self.dispatches == self.kill_at_dispatch:
                raise ChaosFault(
                    f"preempted at dispatch {self.dispatches}"
                )
            return self._real(*a, **kw)

        host.processor.dispatch_batch = dispatch

    def disarm(self) -> None:
        if self._host is not None and self._real is not None:
            self._host.processor.dispatch_batch = self._real
        self._host = None


class SinkOutageInjector(Injector):
    """Sink outage in two severities: ``fail=True`` makes every write
    raise (hard outage — proves whole-window requeue); ``delay_s``
    makes writes slow (brown-out — landings queue behind the dispatch
    loop, the ``Transfer_Background_Pending`` signal the pilot turns
    into backpressure). Wraps every sink of every output operator."""

    name = "sink-outage"

    def __init__(self, fail: bool = False, delay_s: float = 0.0):
        self.fail = fail
        self.delay_s = delay_s
        self.writes = 0
        self._restores: List = []

    def arm(self, host) -> None:
        for op in host.dispatcher.operators.values():
            for i, sink in enumerate(list(op.sinks)):
                self._restores.append((op, i, sink))
                op.sinks[i] = _WrappedSink(self, sink)

    def disarm(self) -> None:
        for op, i, sink in self._restores:
            op.sinks[i] = sink
        self._restores = []


class _WrappedSink:
    def __init__(self, injector: SinkOutageInjector, inner):
        self._injector = injector
        self._inner = inner
        self.kind = getattr(inner, "kind", "wrapped")

    def write(self, dataset, rows, batch_time_ms):
        self._injector.writes += 1
        if self._injector.fail:
            raise ChaosFault("sink outage")
        if self._injector.delay_s:
            time.sleep(self._injector.delay_s)
        return self._inner.write(dataset, rows, batch_time_ms)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class DeviceSlowdownInjector(Injector):
    """Device-step slowdown: every counts sync takes ``extra_s``
    longer — the signal shape of a hot-key-skewed batch (one giant
    group serializes the groupby scan) without needing a real hot
    group to saturate a CPU-sim device. Drives ``Pipeline_Stall_Ms``
    and the stall EWMA, the pilot's depth-down signal."""

    name = "device-slowdown"

    def __init__(self, extra_s: float = 0.05):
        self.extra_s = extra_s
        self._host = None
        self._real = None

    def arm(self, host) -> None:
        self._host = host
        self._real = host.processor.dispatch_batch
        extra = self.extra_s

        def dispatch(*a, **kw):
            handle = self._real(*a, **kw)
            inner_counts = handle.collect_counts

            def slow_counts(*ca, **ckw):
                time.sleep(extra)
                return inner_counts(*ca, **ckw)

            handle.collect_counts = slow_counts
            return handle

        host.processor.dispatch_batch = dispatch

    def disarm(self) -> None:
        if self._host is not None and self._real is not None:
            self._host.processor.dispatch_batch = self._real
        self._host = None


class PartitionLossInjector(Injector):
    """Corrupt a state-partition snapshot MID-HANDOFF: between a
    predecessor's stop and the successor's first load, the ACTIVE
    side's snapshot for one (or every) partition is truncated or
    replaced with garbage — the torn-write / lost-object failure a
    rescale can meet in the wild. The successor's loader must fall
    back to the STANDBY side (DX530, ``State_LoadFallback_Count``) —
    or load the partition empty when both sides are gone (DX531) — and
    at-least-once replay of the un-acked window re-aggregates what the
    standby was missing.

    Targets either the local partition layout (``location=`` — a state
    table's dir) or the shared objstore mirror (``store_url=`` — what a
    cross-host successor actually pulls). ``table`` selects the prefix
    (a state-table name, or ``__window__`` for ring snapshots);
    ``partition=None`` corrupts every partition that has a pointer."""

    name = "partition-loss"
    _GARBAGE = b"\x00\xffPK-not-an-npz\x00truncated"

    def __init__(self, location: Optional[str] = None,
                 store_url: Optional[str] = None,
                 table: str = "", partition: Optional[int] = None,
                 mode: str = "truncate", filename: str = "table.npz"):
        if (location is None) == (store_url is None):
            raise ValueError("exactly one of location/store_url required")
        self.location = location
        self.store_url = store_url
        self.table = table
        self.partition = partition
        self.mode = mode
        self.filename = filename
        self.corrupted: List[str] = []

    # the stop->successor gap has no live host; arm/disarm keep the
    # Injector seam contract for drills that hold one anyway
    def arm(self, host) -> None:
        self.corrupt()

    def disarm(self) -> None:
        pass

    def _payload(self, original: Optional[bytes]) -> bytes:
        if self.mode == "truncate" and original:
            return original[: max(1, len(original) // 3)]
        return self._GARBAGE

    def corrupt(self) -> List[str]:
        """Apply the corruption; returns the snapshot paths/keys hit."""
        import os

        self.corrupted = []
        if self.location is not None:
            from ..runtime.statepartition import LocalSnapshotStore

            store = LocalSnapshotStore(self.location)
            prefixes = (
                [f"p{self.partition:02d}"] if self.partition is not None
                else sorted(
                    d for d in os.listdir(self.location)
                    if d.startswith("p") and os.path.isdir(
                        os.path.join(self.location, d))
                )
            )
            for prefix in prefixes:
                side = store.get_pointer(prefix)
                if side is None:
                    continue
                path = os.path.join(self.location, prefix, side,
                                    self.filename)
                if not os.path.exists(path):
                    continue
                with open(path, "rb") as f:
                    original = f.read()
                with open(path, "wb") as f:
                    f.write(self._payload(original))
                self.corrupted.append(path)
            return self.corrupted

        from ..compile.aotcache import _parse_objstore_url
        from ..serve.objectstore import ObjectStoreClient

        endpoint, bucket, root = _parse_objstore_url(self.store_url)
        client = ObjectStoreClient(endpoint, bucket)
        base = f"{root}/{self.table}" if root else self.table
        parts = (
            [self.partition] if self.partition is not None
            else range(64)
        )
        for p in parts:
            pkey = f"{base}/p{int(p):02d}"
            pointer = client.get(f"{pkey}/pointer")
            if pointer is None:
                continue
            side = pointer.decode().strip()
            key = f"{pkey}/{side}/{self.filename}"
            original = client.get(key)
            if original is None:
                continue
            client.put(key, self._payload(original))
            self.corrupted.append(key)
        return self.corrupted


# ---------------------------------------------------------------------------
# Harness pieces the scenario suite (and tests) assert against
# ---------------------------------------------------------------------------
class RecordingSink:
    """Sink that records every successful write in arrival order — the
    exactly-once witness: after a chaos run, the recorded event ids
    must be each expected id exactly once, in FIFO batch order."""

    kind = "recording"

    def __init__(self):
        self.batches = []  # (batch_time_ms, [row dict, ...])

    def write(self, dataset, rows, batch_time_ms):
        self.batches.append((batch_time_ms, list(rows)))
        return len(rows)

    def values(self, field: str = "seq") -> List:
        return [r[field] for _t, rows in self.batches for r in rows]


class RecordingRescaler:
    """Stand-in ``JobOperation`` for in-process chaos drills: records
    every ``rescale`` call the pilot's ``ScaleActuator`` makes (there
    is no control plane inside a host-only scenario) and reports the
    requested replica set as live."""

    def __init__(self):
        self.calls: List[int] = []

    def rescale(self, job_name: str, replicas: int) -> List[dict]:
        self.calls.append(int(replicas))
        return [
            {"name": job_name if i == 0 else f"{job_name}-r{i + 1}"}
            for i in range(int(replicas))
        ]


# ---------------------------------------------------------------------------
# Payload synthesis
# ---------------------------------------------------------------------------
def skewed_events(
    n: int,
    hot_key: int = 0,
    hot_fraction: float = 0.9,
    n_keys: int = 8,
    seed: int = 7,
) -> List[dict]:
    """Hot-key-skewed stream: ``hot_fraction`` of events carry
    ``hot_key``, the rest spread over ``n_keys``. ``seq`` makes every
    event globally unique so exactly-once delivery stays assertable
    even with key collisions."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        k = hot_key if rng.random() < hot_fraction else rng.randrange(
            1, max(2, n_keys)
        )
        out.append({"k": k, "v": float(i), "seq": i})
    return out


def malformed_payload(
    rows: List[dict], flood_ratio: float = 0.5, seed: int = 11
) -> bytes:
    """Newline-delimited JSON with ``flood_ratio`` of the LINES
    replaced by garbage (truncated JSON, bare text, binary noise) —
    the malformed-input flood. Valid rows keep their relative order;
    the decoders skip garbage lines, so exactly-once applies to the
    valid subset."""
    rng = random.Random(seed)
    garbage = (
        b'{"k": 1, "v":',
        b"not json at all",
        b'{"k"}',
        b"\x00\xff\xfe binary noise",
        b'[1, 2, "unclosed',
    )
    lines = []
    n_bad = int(len(rows) * flood_ratio / max(1e-9, 1.0 - flood_ratio))
    bad_left = n_bad
    for r in rows:
        while bad_left > 0 and rng.random() < flood_ratio:
            lines.append(garbage[rng.randrange(len(garbage))])
            bad_left -= 1
        lines.append(json.dumps(r).encode())
    for _ in range(bad_left):
        lines.append(garbage[rng.randrange(len(garbage))])
    return b"\n".join(lines) + b"\n"


def feed_socket(source, payload: bytes, expect_events: Optional[int] = None,
                timeout_s: float = 5.0) -> None:
    """Push a raw payload into a ``SocketSource`` and wait until its
    buffer holds ``expect_events`` lines (malformed lines count — the
    source buffers lines, the decoder drops garbage later)."""
    import socket as _socket

    conn = _socket.create_connection(("127.0.0.1", source.port), timeout=5)
    conn.sendall(payload)
    conn.close()
    if expect_events is None:
        expect_events = payload.count(b"\n")
    deadline = time.time() + timeout_s
    while time.time() < deadline and len(source._buf) < expect_events:
        time.sleep(0.01)
    if len(source._buf) < expect_events:
        raise TimeoutError(
            f"socket source buffered {len(source._buf)}/{expect_events}"
        )
