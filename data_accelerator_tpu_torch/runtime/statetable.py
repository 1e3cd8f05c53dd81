"""Accumulation (state) tables on key-range partitions with A/B
active-standby persistence per partition.

reference: datax-host handler/StateTableHandler.scala:17-129 — each
``--DataXStates--`` table persists as two Parquet dirs A/B plus a
``metadata.info`` pointer naming the active one; a batch writes the new
state into the standby dir, flips the pointer in memory, and persist()
writes the pointer file after outputs succeed. Restart loads the dir the
pointer names — crash between write and persist leaves the old state
active (consistent with at-least-once replay).

This module keeps exactly those semantics but PER PARTITION: rows hash
onto a small conf'd number of key-range partitions
(``datax.job.process.state.partitions``, runtime/statepartition.py),
each with its own A/B pair + pointer, laid out as
``<location>/p<NN>/{A,B}/{table.npz,meta.json}`` + ``p<NN>/pointer``.
A replica owns a contiguous partition range and reads/writes ONLY its
owned partitions — which is what turns a rescale into a partition
handoff (the successor pulls its assigned partitions, from the local
dir or the shared ``objstore://`` mirror) instead of a state loss.

Durability (the checkpointers' contract):
every snapshot file AND the pointer commit go through tmp-write +
fsync + ``_durable_replace`` (file and directory fsynced), so a torn
write after power loss can never surface as the active snapshot.
Corrupt/truncated snapshots no longer kill the host: ``load()`` falls
back to the standby side (counted in ``State_LoadFallback_Count``,
flight-recorded as DX530) and to an empty partition when both sides
are bad (DX531) — replay of the un-acked window re-aggregates what
the standby was missing.

A partition snapshot is a ``.npz`` of compacted row columns + a JSON
sidecar with types and the string-dictionary entries its ids reference.

The port of the JAX package's ``runtime/statetable.py``, with the same
layout, fallback rules and accounting, so each package loads the
other's partitions. What differs: ``load()`` and ``empty()`` build torch
tensors on the table's ``device`` (``"cuda"`` by default, as every entry
point of the port), and ``overwrite()`` takes HOST arrays (numpy, or
tensors on the CPU): the processor copies a batch's new state off the
card with its outputs and overwrites from the landing thread, so no
state read blocks the dispatch thread.
"""

from __future__ import annotations

import io
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..compile.planner import TableData, ViewSchema
from ..core.schema import StringDictionary
from .statepartition import (
    DEFAULT_STATE_PARTITIONS,
    LocalSnapshotStore,
    ObjstoreSnapshotStore,
    other_side,
    partition_ids,
)

logger = logging.getLogger(__name__)


@dataclass
class StateTable:
    name: str
    schema: ViewSchema
    capacity: int
    location: str  # base dir holding p<NN>/{A,B}/... + p<NN>/pointer
    partitions: int = DEFAULT_STATE_PARTITIONS
    owned: Optional[Sequence[int]] = None  # None = every partition
    partition_key: Optional[str] = None  # default: first schema column
    mirror: Optional[ObjstoreSnapshotStore] = None
    # shared accounting surfaces (FlowProcessor.state_stats/state_events
    # when constructed by the engine): fallbacks/pushes/pulls counted
    # into State_* metrics, DX53x events flight-recorded by the host
    stats: Dict[str, float] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)
    # where load() and empty() build the table
    device: "torch.device | str" = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.partitions = max(1, int(self.partitions))
        self._local = LocalSnapshotStore(self.location)
        if self.owned is None:
            self.owned = list(range(self.partitions))
        else:
            self.owned = sorted(int(p) for p in self.owned)
        if self.partition_key is None:
            self.partition_key = next(iter(self.schema.types))
        elif self.partition_key not in self.schema.types:
            raise ValueError(
                f"state table {self.name!r} has no partition-key column "
                f"{self.partition_key!r} (columns: {list(self.schema.types)})"
            )
        # per-partition in-memory active side (the flip overwrite()
        # makes before persist() commits it) and the standby sides
        # overwrite() staged but persist() has not yet committed
        self._active: Dict[int, str] = {
            p: self._local.get_pointer(self._prefix(p)) or "A"
            for p in self.owned
        }
        self._pending: Dict[int, str] = {}
        # rows last persisted per partition (-1 = unknown): lets
        # overwrite() skip partitions that stay empty, so a sparse key
        # space doesn't pay P snapshot writes per batch
        self._last_counts: Dict[int, int] = {}

    # -- layout ----------------------------------------------------------
    def _prefix(self, p: int) -> str:
        return f"p{int(p):02d}"

    def _mirror_prefix(self, p: int) -> str:
        # the mirror URL is flow-level shared; the table name keys it
        return f"{self.name}/p{int(p):02d}"

    def _key_kind(self) -> str:
        return self.schema.types[self.partition_key]

    # -- load/store ------------------------------------------------------
    def _read_side(self, p: int, side: str) -> Optional[Dict]:
        """One partition side as {'cols': {name: np rows}, 'strings':
        {id: str}} — compacted valid rows only. None when absent;
        raises on a corrupt/truncated snapshot (the caller's cue to
        fall back)."""
        prefix = self._prefix(p)
        npz = self._local.get_file(prefix, side, "table.npz")
        meta_raw = self._local.get_file(prefix, side, "meta.json")
        if npz is None or meta_raw is None:
            return None
        meta = json.loads(meta_raw.decode("utf-8"))
        with np.load(io.BytesIO(npz)) as z:
            cols = {c: z[c] for c in self.schema.types if c in z.files}
        if set(cols) != set(self.schema.types):
            raise ValueError(
                f"partition {p} snapshot missing columns "
                f"{set(self.schema.types) - set(cols)}"
            )
        return {"cols": cols, "strings": meta.get("strings", {})}

    def _pull_partition(self, p: int) -> bool:
        """Fetch one partition from the objstore mirror into the local
        layout (both sides + pointer) — the successor-replica handoff
        path. Fail-closed: mirror errors propagate."""
        if self.mirror is None:
            return False
        mprefix = self._mirror_prefix(p)
        pointer = self.mirror.get_pointer(mprefix)
        if pointer is None:
            return False
        pulled = False
        for side in ("A", "B"):
            files = {}
            for fn in ("table.npz", "meta.json"):
                data = self.mirror.get_file(mprefix, side, fn)
                if data is not None:
                    files[fn] = data
            if files:
                self._local.put_files(self._prefix(p), side, files)
                pulled = True
        if pulled:
            self._local.put_pointer(self._prefix(p), pointer)
            self._active[p] = pointer
            self.stats["Snapshot_Pull_Count"] = (
                self.stats.get("Snapshot_Pull_Count", 0) + 1
            )
        return pulled

    def _event(self, code: str, p: int, side: str, message: str) -> None:
        ev = {
            "code": code, "table": self.name, "partition": int(p),
            "side": side, "message": message, "ts": time.time(),
        }
        self.events.append(ev)
        logger.warning("%s: %s", code, message)

    def load(self, dictionary: StringDictionary) -> TableData:
        """Load the owned partitions' active snapshots and concatenate
        them into one capacity-padded table; empty where nothing exists
        yet. A corrupt active side falls back to the standby (DX530,
        ``State_LoadFallback_Count``); when both sides are bad the
        partition loads empty (DX531) and at-least-once replay of the
        un-acked window re-aggregates what it held."""
        rows: Dict[str, List[np.ndarray]] = {c: [] for c in self.schema.types}
        n_rows = 0
        for p in self.owned:
            if (
                self._local.get_pointer(self._prefix(p)) is None
                and self.mirror is not None
            ):
                self._pull_partition(p)
            pointer = self._local.get_pointer(self._prefix(p)) \
                or self._active.get(p, "A")
            part = None
            for attempt, side in enumerate((pointer, other_side(pointer))):
                try:
                    part = self._read_side(p, side)
                    # an ABSENT active side (returned None without
                    # raising) is a fresh partition and loads EMPTY —
                    # never the standby: after a crash between
                    # overwrite() (standby written, in-memory flip)
                    # and persist() (pointer never committed) the
                    # standby holds the UNCOMMITTED batch, and loading
                    # it double-counts the replayed un-acked window
                    break
                except Exception as e:  # noqa: BLE001 — corrupt snapshot
                    self.stats["LoadFallback_Count"] = (
                        self.stats.get("LoadFallback_Count", 0) + 1
                    )
                    if attempt == 0:
                        self._event(
                            "DX530", p, side,
                            f"state {self.name} partition {p}: active "
                            f"side {side} unreadable ({e}); falling back "
                            f"to standby",
                        )
                        continue
                    self._event(
                        "DX531", p, side,
                        f"state {self.name} partition {p}: BOTH sides "
                        f"unreadable ({e}); loading empty — un-acked "
                        f"window replay re-aggregates",
                    )
                    part = None
            if part is None:
                continue
            # remap persisted dictionary ids into the live dictionary
            id_map = {
                int(k): dictionary.encode(v)
                for k, v in part["strings"].items()
            }
            count = None
            for c, t in self.schema.types.items():
                arr = part["cols"][c]
                count = len(arr) if count is None else min(count, len(arr))
                if t == "string":
                    arr = np.array(
                        [id_map.get(int(v), 0) for v in arr], dtype=np.int32
                    )
                rows[c].append(arr)
            n_rows += count or 0
        if n_rows == 0:
            return self.empty()
        if n_rows > self.capacity:
            logger.warning(
                "state %s: %d restored rows exceed capacity %d; truncating",
                self.name, n_rows, self.capacity,
            )
        cols: Dict[str, torch.Tensor] = {}
        for c, t in self.schema.types.items():
            merged = np.concatenate(rows[c])[: self.capacity]
            out = np.zeros((self.capacity,), dtype=_NP_DTYPES.get(t, np.int32))
            out[: len(merged)] = merged.astype(out.dtype)
            cols[c] = torch.from_numpy(out).to(self.device)
        valid = np.zeros((self.capacity,), dtype=bool)
        valid[: min(n_rows, self.capacity)] = True
        return TableData(cols, torch.from_numpy(valid).to(self.device))

    def overwrite(self, table: TableData, dictionary: StringDictionary) -> None:
        """Write new state into each owned partition's standby side and
        flip in memory (StateTableHandler.scala:99-115, per partition).
        Rows hash onto partitions by the key column; rows of un-owned
        partitions are NOT persisted here (a key-routed ingest never
        produces them — see ``process.state.filteringest``). ``table``
        holds host arrays: a CUDA tensor raises rather than sync."""
        cols = {k: np.asarray(v) for k, v in table.cols.items()}
        valid = np.asarray(table.valid)
        pids = partition_ids(
            cols[self.partition_key], self.partitions, self._key_kind(),
            dictionary=dictionary,
        )
        string_cols = [
            c for c, t in self.schema.types.items() if t == "string"
        ]
        for p in self.owned:
            member = valid & (pids == p)
            idx = np.nonzero(member)[0]
            if idx.size == 0 and self._last_counts.get(p, -1) == 0:
                continue  # stayed empty: nothing to re-snapshot
            self._last_counts[p] = int(idx.size)
            strings: Dict[str, str] = {}
            for c in string_cols:
                for sid in np.unique(cols[c][idx]) if idx.size else ():
                    s = dictionary.decode(int(sid))
                    if s is not None:
                        strings[str(int(sid))] = s
            buf = io.BytesIO()
            np.savez(buf, **{c: cols[c][idx] for c in self.schema.types})
            files = {
                "table.npz": buf.getvalue(),
                "meta.json": json.dumps(
                    {"types": dict(self.schema.types), "strings": strings}
                ).encode("utf-8"),
            }
            side = other_side(self._active.get(p, "A"))
            self._local.put_files(self._prefix(p), side, files)
            self._active[p] = side  # flip in memory; persist() commits
            self._pending[p] = side

    def persist(self) -> None:
        """Commit the pointers after outputs succeed
        (StateTableHandler.scala:117-125) — the exactly-once point,
        fsynced (file + directory) so it survives power loss. With an
        ``objstore://`` mirror the committed sides + pointers push to
        the shared store afterward, fail-closed: a push failure raises
        so the batch requeues rather than acking state that never
        shipped."""
        committed = dict(self._pending)
        for p, side in committed.items():
            self._local.put_pointer(self._prefix(p), side)
        if self.mirror is not None and committed:
            for p, side in committed.items():
                files = {}
                for fn in ("table.npz", "meta.json"):
                    data = self._local.get_file(self._prefix(p), side, fn)
                    if data is not None:
                        files[fn] = data
                mprefix = self._mirror_prefix(p)
                self.mirror.put_files(mprefix, side, files)
                self.mirror.put_pointer(mprefix, side)
            self.stats["Snapshot_Push_Count"] = (
                self.stats.get("Snapshot_Push_Count", 0) + len(committed)
            )
        self._pending.clear()

    def empty(self) -> TableData:
        cols = {
            c: torch.zeros(
                (self.capacity,),
                dtype={"double": torch.float32, "boolean": torch.bool}.get(t, torch.int32),
                device=self.device,
            )
            for c, t in self.schema.types.items()
        }
        return TableData(
            cols, torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        )


# column type -> host dtype of a loaded partition (the dtypes of empty())
_NP_DTYPES = {"double": np.float32, "boolean": np.bool_}
