"""Buffer sanitizer: the DYNAMIC half of the DX8xx buffer-lifetime
story (``analysis/racecheck.py`` is the static half).

Copy of the JAX package's ``runtime/sanitizer.py`` with the same
sentinel, run threshold, events and metrics. What differs is what a
buffer is in the port:

* **Pool slots** (``native/decoder.py::PackedBufferPool``) are torch
  int32 matrices, page-locked on a CUDA processor. A released slot is
  poisoned with the sentinel once nothing reads it any more: on the CPU
  at once (the step read it and has landed), on a card only after the
  CUDA event of its host-to-device copy has completed, checked with a
  non-blocking ``query`` when the pool is next touched. Poisoning a
  matrix whose copy is still in flight would corrupt the batch on the
  card, the very bug the sanitizer hunts. A view of a slot that outlived
  its release then reads sentinels (``scan_table``).
* **Window rings** are torch tensors. On the CPU a snapshot aliases them
  when it holds ``ring.numpy()`` instead of a copy, and
  ``check_snapshot`` compares against exactly that view. On a card the
  rings live in device memory, which no host array can share; there a
  snapshot can alias only another snapshot's host memory, so the
  sanitizer also holds the previous snapshot's arrays by ``weakref``
  and flags a new snapshot that shares memory with one still alive.
* **Sink payloads and checkpoints** are host numpy arrays, scanned for
  sentinel runs as in the reference.

Every hit becomes a runtime **DX805** event (drained by the host into
the flight recorder) and bumps ``Sanitizer_PoisonHit_Count``; everything
the sanitizer guarded bumps ``Sanitizer_GuardedViews_Count``. Armed by
conf ``datax.job.process.debug.buffersanitizer`` (a debug mode: poisoning
costs one host memset per released slot).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

# 0x5A5A5A5A: the classic poison byte pattern (ASan uses 0xbe/0xbd
# regions; 'Z' bytes read obviously-wrong in both int32 and f32 views)
SENTINEL = np.int32(0x5A5A5A5A)
# a single sentinel word can occur in honest data; four consecutive
# words (16 bytes) cannot, outside astronomically unlucky payloads
MIN_RUN = 4


def _host_array(a) -> Optional[np.ndarray]:
    """``a`` as a numpy array over the same memory: a CPU tensor's
    ``.numpy()`` view, an array as it is. None for a tensor on a card,
    which no host buffer can alias and no host scan reads."""
    if isinstance(a, torch.Tensor):
        return a.numpy() if a.device.type == "cpu" else None
    return np.asarray(a)


def _longest_sentinel_run(arr) -> int:
    """Longest run of consecutive SENTINEL words in ``arr`` viewed as
    int32 (0 when the dtype is not 4-byte or nothing matches)."""
    try:
        a = _host_array(arr)
        if a is None:
            return 0
        a = np.ascontiguousarray(a)
    except Exception:  # noqa: BLE001 — exotic array-likes never fail a scan
        return 0
    if a.dtype.itemsize != 4 or a.size < MIN_RUN:
        return 0
    flat = a.view(np.int32).ravel()
    idx = np.flatnonzero(flat == SENTINEL)
    if idx.size < MIN_RUN:
        return 0
    # split the match positions into consecutive runs
    breaks = np.flatnonzero(np.diff(idx) != 1)
    best = 0
    start = 0
    for b in list(breaks) + [idx.size - 1]:
        best = max(best, int(b - start + 1))
        start = b + 1
    return best


class BufferSanitizer:
    """Poison released pool slots; scan outputs/checkpoints for leaks.

    Thread-safe: poisoning happens on whatever thread releases a slot
    (dispatch or landing), scans run on the landing thread, and the
    host drains events/metrics at collect time.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.poison_count = 0       # slots poisoned (lifetime)
        self.guarded_views = 0      # buffers guarded: poisons + scans
        self.poison_hits = 0        # DX805s fired (lifetime)
        self._events: List[Dict[str, object]] = []
        self._hits_drained = 0
        self._guarded_drained = 0
        # the arrays of the last checked snapshot, held weakly: a new
        # snapshot sharing memory with one still alive is an alias
        self._last_snapshot: List[weakref.ref] = []

    # -- the poisoning half (pool release hook) ---------------------------
    def poison(self, matrix) -> None:
        """Overwrite a RELEASED pool matrix (a host tensor or array) with
        the sentinel. Safe by ownership: the pool holds the only
        legitimate reference, and the caller has seen its copy to the
        card complete."""
        try:
            if isinstance(matrix, torch.Tensor):
                matrix.fill_(int(SENTINEL))
            else:
                matrix.fill(SENTINEL)
        except (ValueError, AttributeError, RuntimeError):
            return  # read-only or not an array: nothing to guard
        with self._lock:
            self.poison_count += 1
            self.guarded_views += 1

    # -- the scanning half ------------------------------------------------
    def check_snapshot(
        self, snap: Dict[str, object], window_buffers: Dict[str, object],
    ) -> int:
        """Guard a ``snapshot_window_state`` result: every saved array
        must be a REAL copy (no shared memory with the live rings, nor
        with an earlier snapshot still alive) and sentinel-free. Returns
        the number of new hits."""
        before = self.poison_hits
        rings = snap.get("rings", {}) if isinstance(snap, dict) else {}
        earlier = [a for a in (r() for r in self._last_snapshot) if a is not None]
        saved_arrays: List[np.ndarray] = []
        for table, saved in rings.items():
            live = window_buffers.get(table)
            arrays = dict(saved.get("cols", {}))
            arrays["__valid__"] = saved.get("valid")
            for cname, a in arrays.items():
                if a is None:
                    continue
                with self._lock:
                    self.guarded_views += 1
                run = _longest_sentinel_run(a)
                if run >= MIN_RUN:
                    self._record(
                        kind="sentinel-run", where="checkpoint",
                        table=table, column=cname, run=run,
                    )
                a = _host_array(a)
                if a is None:
                    continue
                saved_arrays.append(a)
                others = list(earlier)
                # a ring under a mesh is held as shards: each is live
                for part in getattr(live, "shards", [live]) if live is not None else ():
                    live_arr = (
                        part.valid if cname == "__valid__"
                        else part.cols.get(cname)
                    )
                    if live_arr is None:
                        continue
                    # the ring's own memory, viewed: only a CPU ring has
                    # host memory to share
                    # dx-race: allow-zero-copy read-only identity probe —
                    # the view dies inside this call, nothing escapes
                    live_np = _host_array(live_arr)
                    if live_np is not None:
                        others.append(live_np)
                if any(np.shares_memory(a, o) for o in others):
                    self._record(
                        kind="snapshot-alias", where="checkpoint",
                        table=table, column=cname, run=0,
                    )
        self._last_snapshot = [weakref.ref(a) for a in saved_arrays]
        return self.poison_hits - before

    def scan_table(self, name: str, table) -> int:
        """Scan one landed host output table (sink payload) for
        sentinel leakage. Returns the number of new hits."""
        before = self.poison_hits
        arrays = dict(getattr(table, "cols", {}) or {})
        valid = getattr(table, "valid", None)
        if valid is not None:
            arrays["__valid__"] = valid
        for cname, a in arrays.items():
            with self._lock:
                self.guarded_views += 1
            run = _longest_sentinel_run(a)
            if run >= MIN_RUN:
                self._record(
                    kind="sentinel-run", where="sink", table=name,
                    column=cname, run=run,
                )
        return self.poison_hits - before

    # -- event/metric drains (host collect cadence) -----------------------
    def _record(self, kind: str, where: str, table: str, column: str,
                run: int) -> None:
        with self._lock:
            self.poison_hits += 1
            self._events.append({
                "code": "DX805",
                "kind": kind,
                "where": where,
                "table": str(table),
                "column": str(column),
                "runLength": int(run),
                "message": (
                    f"DX805: {kind} in {where} table {table!r} column "
                    f"{column!r}"
                    + (f" ({run} sentinel words)" if run else "")
                    + " — a donated/pooled buffer view outlived its "
                    "buffer (use-after-release)"
                ),
            })

    def drain_events(self) -> List[Dict[str, object]]:
        """DX805 events since the last drain (flight-recorder feed)."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def drain_metric_deltas(self) -> Dict[str, float]:
        """Sanitizer_* metric deltas since the last drain; hit count is
        only reported once nonzero (silence == health, like the other
        incident counters)."""
        with self._lock:
            hits = self.poison_hits - self._hits_drained
            self._hits_drained = self.poison_hits
            guarded = self.guarded_views - self._guarded_drained
            self._guarded_drained = self.guarded_views
        out: Dict[str, float] = {}
        if guarded:
            out["Sanitizer_GuardedViews_Count"] = float(guarded)
        if hits:
            out["Sanitizer_PoisonHit_Count"] = float(hits)
        return out


def from_conf(dbg_conf) -> Optional[BufferSanitizer]:
    """``datax.job.process.debug.buffersanitizer=true`` arms the
    sanitizer (``dbg_conf`` is the ``debug.`` sub-dictionary)."""
    # dx-conf: read debug.buffersanitizer default=false
    flag = (dbg_conf.get_or_else("buffersanitizer", "false") or "").lower()
    return BufferSanitizer() if flag == "true" else None
