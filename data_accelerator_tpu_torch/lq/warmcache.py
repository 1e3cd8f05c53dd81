"""Signature-keyed warm-kernel LRU for the LiveQuery serving plane.

A compiled interactive kernel is keyed by its COMPILE SIGNATURE — flow
hash x pow2 row bucket x query shape — not by the session that asked
for it. Thousands of tenants viewing the same designer flow share ONE
resident kernel; the pow2 bucket lattice (``serve/livequery._capacity_for``)
keeps the set of reachable signatures bounded no matter how many users
connect, so the compile surface is a function of the lattice, not of
tenant count.

Residency is budgeted in device bytes: each entry is priced after its
first execute with the byte model of the port's own,
``FlowProcessor.device_bytes`` (the resident tensor storages each of
the kernel's processors holds on its device), and the LRU evicts
(counted — ``LQ_KernelEvict_Count``) when the resident total exceeds
``costmodel.warm_kernel_cache_budget_bytes`` of the device's memory.
A re-admitted signature rebuilds its processors (counted as a re-warm,
so dashboards can tell thrash from cold).

A copy of the JAX package's ``lq/warmcache.py`` with these changes: the
cache takes ``device`` (``"cuda"`` by default; raises without a card)
and builds its kernels there; entries are priced by
``FlowProcessor.device_bytes`` where the JAX package runs
``analysis/deviceplan.analyze_processor`` (``jax.eval_shape``), not
ported yet; the ``sized_by`` vocabulary and ``FALLBACK_KERNEL_BYTES``
stay. ``clear`` drops every entry (``LiveQueryService.stop``). No entry,
kernel or processor refers back to the cache, so an evicted entry's
tensors go by reference counting, without the cyclic collector.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

logger = logging.getLogger(__name__)

#: conservative per-entry estimate when the byte model cannot price a
#: kernel — large enough that fallback-sized entries still get evicted
#: under pressure
FALLBACK_KERNEL_BYTES = 64 * 1024 * 1024


@dataclass(frozen=True)
class CompileSignature:
    """flow-hash x pow2 row bucket x query shape — the unit of compile
    sharing. Everything that can change a trace is in the flow hash
    (schema, normalization, refdata, udf set, debug flags, compile
    conf); everything that cannot is deliberately left out so sessions
    coalesce."""

    flow_hash: str
    row_bucket: int
    query_shape: str

    @property
    def key(self) -> str:
        return f"{self.flow_hash}:{self.row_bucket}:{self.query_shape}"


def _normalize_query(query: str) -> str:
    """Whitespace-insensitive query shape: the designer re-sending the
    same query with different formatting must not fork the compile
    surface."""
    return " ".join((query or "").split())


def flow_hash_for(
    flow_name: str,
    schema_json: str,
    normalization: str,
    refdata_conf: Optional[Dict[str, str]] = None,
    udfs: Optional[dict] = None,
    debug: object = None,
    compile_conf: Optional[Dict[str, str]] = None,
) -> str:
    """Digest of every session field that shapes the compiled trace."""
    h = hashlib.sha1()
    h.update(json.dumps([
        flow_name,
        schema_json,
        normalization,
        sorted((refdata_conf or {}).items()),
        sorted(udfs.keys()) if isinstance(udfs, dict) else bool(udfs),
        debug if isinstance(debug, (bool, type(None))) else sorted(
            dict(debug or {}).items()
        ),
        sorted((compile_conf or {}).items()),
    ], default=str).encode())
    return h.hexdigest()[:16]


def signature_for(session, query: str,
                  compile_conf: Optional[Dict[str, str]] = None
                  ) -> CompileSignature:
    """The compile signature of one execute: session flow fields +
    the pow2 bucket its row count pads into + the normalized query."""
    from ..serve.livequery import _capacity_for

    return CompileSignature(
        flow_hash=flow_hash_for(
            session.flow_name, session.schema_json, session.normalization,
            session.refdata_conf, session.udfs, session.debug,
            compile_conf,
        ),
        row_bucket=_capacity_for(len(session.sample_rows)),
        query_shape=_normalize_query(query),
    )


def rows_digest(rows) -> str:
    """Identity of one execute's input rows — the coalescer fans one
    dispatch out to every queued call whose (signature, rows digest,
    query, max_rows) match, which is the common many-users-one-
    dashboard case."""
    h = hashlib.sha1()
    for r in rows:
        h.update(json.dumps(r, sort_keys=True, default=str).encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


class WarmKernel:
    """One resident compiled kernel: a ``serve.livequery.Kernel`` bound
    to a signature's flow fields and row bucket, executed with whatever
    rows the tick hands it (sessions in the same bucket share it)."""

    def __init__(self, signature: CompileSignature, kernel):
        self.signature = signature
        self.kernel = kernel
        self.hbm_bytes = 0
        self.sized_by = "unsized"
        self.last_used = 0.0
        self.executes = 0

    def execute(self, rows, query: str, max_rows: int) -> dict:
        # the tick runner is single-threaded per cache (the coalescer's
        # run lock), so re-pointing the kernel at this call's rows is
        # safe; capacity stays the signature's bucket by construction
        self.kernel.sample_rows = list(rows)
        self.executes += 1
        return self.kernel.execute(query, max_rows=max_rows)

    def step_cache_size(self) -> int:
        """Total step builds across this kernel's query processors
        (``FlowProcessor._step_cache_size``) — the number the coalescing
        proof asserts flat."""
        total = 0
        for proc in self.kernel._processors.values():
            n = proc._step_cache_size()
            total += int(n) if n is not None else 1
        return total


class WarmKernelCache:
    """LRU over ``WarmKernel`` entries, budgeted in device bytes.

    ``budget_bytes`` defaults to ``costmodel.warm_kernel_cache_budget_
    bytes(device=device)`` (a headroom fraction of the device's memory).
    Entries are priced after their first execute builds the processor;
    eviction never removes the entry the current tick is using."""

    def __init__(
        self,
        budget_bytes: Optional[int] = None,
        compile_conf: Optional[Dict[str, str]] = None,
        now_fn: Callable[[], float] = time.time,
        device: "torch.device | str" = "cuda",
    ):
        from ..serve.livequery import require_device

        self.device = str(require_device(device))
        if budget_bytes is None:
            from ..analysis.costmodel import warm_kernel_cache_budget_bytes

            budget_bytes = warm_kernel_cache_budget_bytes(device=self.device)
        self.budget_bytes = int(budget_bytes)
        self.compile_conf = dict(compile_conf or {})
        self.now = now_fn
        self._entries: Dict[str, WarmKernel] = {}
        self._lock = threading.RLock()
        self._seen_signatures: set = set()
        self.evictions = 0
        self.rewarms = 0
        self.compiles = 0

    # -- acquisition ------------------------------------------------------
    def acquire(self, signature: CompileSignature, session) -> WarmKernel:
        """The signature's resident kernel, building one from the
        session's flow fields on miss. A miss for a signature seen
        before is a RE-WARM: its processors are built again (no
        persistent compile cache reads ``compile_conf`` in the port)."""
        from ..serve.livequery import Kernel

        with self._lock:
            entry = self._entries.get(signature.key)
            if entry is None:
                if signature.key in self._seen_signatures:
                    self.rewarms += 1
                self._seen_signatures.add(signature.key)
                self.compiles += 1
                kernel = Kernel(
                    id=f"warm-{signature.flow_hash}-{signature.row_bucket}",
                    flow_name=session.flow_name,
                    schema_json=session.schema_json,
                    normalization=session.normalization,
                    sample_rows=list(session.sample_rows),
                    udfs=session.udfs,
                    refdata_conf=dict(session.refdata_conf or {}),
                    debug=session.debug,
                    compile_conf=dict(self.compile_conf),
                    device=self.device,
                )
                entry = WarmKernel(signature, kernel)
                self._entries[signature.key] = entry
            entry.last_used = self.now()
            return entry

    # -- budget enforcement ----------------------------------------------
    def _price_entry(self, entry: WarmKernel) -> None:
        """Price the entry with the byte model over its built
        processors (``FlowProcessor.device_bytes``); fall back to a flat
        conservative estimate when the model cannot price it."""
        try:
            total = sum(
                int(proc.device_bytes())
                for proc in entry.kernel._processors.values()
            )
            if total > 0:
                entry.hbm_bytes = total
                entry.sized_by = "model"
                return
        except Exception as e:  # noqa: BLE001 — sizing must not fail a query
            logger.debug("kernel byte model failed for %s: %s",
                         entry.signature.key, e)
        entry.hbm_bytes = FALLBACK_KERNEL_BYTES
        entry.sized_by = "fallback"

    def settle(self, in_use: Optional[WarmKernel] = None) -> int:
        """Price unsized entries and evict LRU until the resident total
        fits the budget (never evicting ``in_use``). Returns evictions
        this pass; the cumulative count feeds ``LQ_KernelEvict_Count``."""
        evicted = 0
        with self._lock:
            for entry in self._entries.values():
                if entry.sized_by == "unsized" and entry.kernel._processors:
                    self._price_entry(entry)
            while len(self._entries) > 1 \
                    and self.resident_bytes() > self.budget_bytes:
                victims = [
                    e for e in self._entries.values() if e is not in_use
                ]
                if not victims:
                    break
                lru = min(victims, key=lambda e: e.last_used)
                del self._entries[lru.signature.key]
                self.evictions += 1
                evicted += 1
        return evicted

    def evict_flow(self, flow_name: str) -> int:
        """Drop every resident kernel built for ``flow_name`` (flow
        delete / refresh cascade)."""
        with self._lock:
            doomed = [
                k for k, e in self._entries.items()
                if e.kernel.flow_name == flow_name
            ]
            for k in doomed:
                del self._entries[k]
            return len(doomed)

    def clear(self) -> int:
        """Drop every resident kernel (a stopped service); not counted
        as evictions. Returns the entries dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    # -- observability ----------------------------------------------------
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.hbm_bytes for e in self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def step_cache_entries(self) -> int:
        """Total step builds across resident kernels — the coalescing
        proof's bounded quantity."""
        with self._lock:
            return sum(
                e.step_cache_size() for e in self._entries.values()
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "residentBytes": self.resident_bytes(),
                "budgetBytes": self.budget_bytes,
                "evictions": self.evictions,
                "rewarms": self.rewarms,
                "compiles": self.compiles,
                "stepCacheEntries": self.step_cache_entries(),
            }
