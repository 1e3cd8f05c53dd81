"""Key-range state partitions: the unit of stateful rescale.

reference: the reference platform's cross-batch accumulators are whole
A/B Parquet tables with one active/standby pointer per table
(StateTableHandler.scala:99-125) and its jobs are fixed-size — state
never moves. Here every stateful surface (accumulator tables,
TIMEWINDOW ring snapshots) is hashed onto a small conf'd number of
key-range partitions (``datax.job.process.state.partitions``, default
16); each replica owns a CONTIGUOUS partition range, so a rescale is a
partition handoff (the successor pulls only the partitions the new map
assigns it), not a state loss.

Pieces:

- **hashing** (``partition_ids``): a splitmix64-style finalizer over
  the key column — deterministic across processes and restarts (python
  ``hash()`` is salted; this must not be), vectorized in numpy, with
  string keys hashed by their decoded utf-8 (dictionary ids are
  process-local and must never leak into placement).
- **ownership** (``owned_partitions`` / ``partition_map``): the
  contiguous balanced split of P partitions over N replicas — replica
  i's range only shrinks/grows at the EDGES as N changes, which is
  what keeps a rescale's handoff set small (the consistent-hash
  property restated for contiguous ranges).
- **snapshot stores**: the per-partition A/B + pointer layout
  (``<prefix>/p<NN>/{A,B}/<file>`` + ``<prefix>/p<NN>/pointer``) over
  two backends — the local filesystem (power-loss durable: tmp-write +
  fsync + directory fsync, ``runtime/checkpoint._durable_replace``)
  and the shared object store (``objstore://`` — what lets a successor
  replica on ANOTHER host warm its partitions). Object-store I/O is
  **fail-closed**: state is correctness, so push/pull retries
  (bounded, jittered — serve/objectstore.py) and then raises; the
  batch fails and the un-acked window requeues rather than committing
  a pointer whose snapshot never landed.
- **window split/merge**: a window-state snapshot
  (``FlowProcessor.snapshot_window_state``) splits into per-partition
  snapshots by hashing the key column per ring row, and partitions
  from SEVERAL predecessors (a scale-down) merge back — rows re-packed
  per slot, timestamps rebased across differing batch bases, string
  ids remapped through each source's own dictionary.

A whole copy of the JAX package's ``runtime/statepartition.py`` (numpy
only): the hashing is bit-identical, so both packages place every key
in the same partition, and the store layouts are the same, so each
package loads the other's snapshots. It reads the port's own
``runtime/checkpoint.py``, ``compile/aotcache.py`` and
``serve/objectstore.py``.
"""

from __future__ import annotations

import io
import logging
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# conf datax.job.process.state.partitions — small on purpose: a
# partition is the handoff granularity, not a parallelism unit, and
# P >> max replicas keeps every contiguous range balanced within one
DEFAULT_STATE_PARTITIONS = 16

SIDES = ("A", "B")


class SnapshotStoreError(IOError):
    """A state-snapshot store operation failed permanently (after the
    bounded retries). Fail-closed: callers let this propagate so the
    batch requeues instead of committing state that never landed."""


def other_side(side: str) -> str:
    return "B" if side == "A" else "A"


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------
_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)
_S33 = np.uint64(33)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64/murmur3 finalizer — a deterministic avalanche so
    adjacent keys don't land in adjacent partitions."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64, copy=True)
        x ^= x >> _S33
        x *= _MIX1
        x ^= x >> _S33
        x *= _MIX2
        x ^= x >> _S33
    return x


def _string_hash(s: str) -> int:
    # crc32 over utf-8: stable across processes (unlike hash()), cheap,
    # and fed through the mixer below so its distribution doesn't matter
    return zlib.crc32(s.encode("utf-8"))


def partition_ids(
    values: np.ndarray,
    partitions: int,
    kind: str = "long",
    dictionary=None,
) -> np.ndarray:
    """Per-row partition id for a key column. ``kind`` follows the
    ViewSchema vocabulary; ``string`` columns carry dictionary ids and
    need the dictionary to hash the DECODED value (ids are assigned in
    encounter order per process — hashing them raw would scatter the
    same logical key across partitions between restarts)."""
    a = np.asarray(values)
    if kind == "string":
        if dictionary is None:
            raise ValueError("string partition keys need the dictionary")
        ids = a.astype(np.int64)
        uniq = np.unique(ids)
        lut = {
            int(i): _string_hash(dictionary.decode(int(i)) or "")
            for i in uniq
        }
        h = np.array([lut[int(i)] for i in ids.ravel()], dtype=np.uint64)
        h = h.reshape(ids.shape)
    elif kind == "double" or a.dtype.kind == "f":
        h = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    elif kind == "boolean" or a.dtype.kind == "b":
        h = a.astype(np.uint64)
    else:
        h = a.astype(np.int64).view(np.uint64)
    return (_mix64(h) % np.uint64(max(1, int(partitions)))).astype(np.int64)


def partition_of(value, partitions: int, kind: str = "long",
                 dictionary=None) -> int:
    """Scalar convenience over ``partition_ids``."""
    if kind == "string" and isinstance(value, str):
        h = np.array([_string_hash(value)], dtype=np.uint64)
        return int(_mix64(h)[0] % np.uint64(max(1, int(partitions))))
    return int(partition_ids(np.array([value]), partitions, kind,
                             dictionary)[0])


# ---------------------------------------------------------------------------
# Ownership
# ---------------------------------------------------------------------------
def owned_partitions(
    replica_index: int, replica_count: int, partitions: int
) -> List[int]:
    """The contiguous partition range replica ``replica_index`` (1-based)
    owns out of ``partitions`` under ``replica_count`` replicas: the
    balanced split where the first ``P % N`` replicas take one extra.
    Every partition is owned by exactly one replica; ranges only move
    at their edges as N changes."""
    if replica_count < 1 or not 1 <= replica_index <= replica_count:
        raise ValueError(
            f"replica index {replica_index} out of range 1..{replica_count}"
        )
    if partitions < 1:
        raise ValueError(f"partitions must be >= 1, got {partitions}")
    base, extra = divmod(partitions, replica_count)
    start = (replica_index - 1) * base + min(replica_index - 1, extra)
    size = base + (1 if replica_index <= extra else 0)
    return list(range(start, start + size))


def partition_map(replica_count: int, partitions: int) -> Dict[int, List[int]]:
    """replica index (1-based) -> owned partition list, covering every
    partition exactly once."""
    return {
        i: owned_partitions(i, replica_count, partitions)
        for i in range(1, max(1, replica_count) + 1)
    }


def reassigned_partitions(
    old_map: Dict, new_map: Dict
) -> List[int]:
    """Partitions whose owner changed between two maps (the handoff
    set of a rescale). Keys may be int or str (JSON round-trip)."""
    def owner_of(m):
        out = {}
        for idx, parts in m.items():
            for p in parts:
                out[int(p)] = int(idx)
        return out

    old_o, new_o = owner_of(old_map), owner_of(new_map)
    return sorted(
        p for p in new_o if old_o.get(p) is not None and old_o[p] != new_o[p]
    ) + sorted(p for p in new_o if p not in old_o and len(old_o) > 0)


# ---------------------------------------------------------------------------
# Snapshot stores: per-partition A/B + pointer over two backends
# ---------------------------------------------------------------------------
class LocalSnapshotStore:
    """The on-disk partition layout with the checkpointers' power-loss
    durability: every file lands via tmp-write + fsync +
    ``_durable_replace`` (file AND directory fsynced), and the pointer
    commit — the exactly-once point — gets the same treatment."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, prefix: str, side: Optional[str] = None) -> str:
        return os.path.join(self.root, prefix, side) if side else \
            os.path.join(self.root, prefix)

    def put_files(self, prefix: str, side: str,
                  files: Dict[str, bytes]) -> None:
        from .checkpoint import _durable_replace

        d = self._dir(prefix, side)
        os.makedirs(d, exist_ok=True)
        for fn, data in files.items():
            path = os.path.join(d, fn)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            _durable_replace(tmp, path)

    def get_file(self, prefix: str, side: str, name: str) -> Optional[bytes]:
        try:
            with open(os.path.join(self._dir(prefix, side), name), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            return None

    def put_pointer(self, prefix: str, side: str) -> None:
        from .checkpoint import _durable_replace

        d = self._dir(prefix)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "pointer")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(side)
            f.flush()
            os.fsync(f.fileno())
        _durable_replace(tmp, path)

    def get_pointer(self, prefix: str) -> Optional[str]:
        try:
            with open(os.path.join(self._dir(prefix), "pointer"),
                      encoding="utf-8") as f:
                p = f.read().strip()
                return p if p in SIDES else None
        except (FileNotFoundError, NotADirectoryError):
            return None


class ObjstoreSnapshotStore:
    """The same partition layout over the shared object store — what a
    successor replica on another host pulls its assigned partitions
    from. FAIL-CLOSED: the underlying client already retries transient
    failures with bounded jittered backoff (serve/objectstore.py); a
    still-failing operation raises ``SnapshotStoreError`` so the
    caller's batch requeues instead of acking state that never shipped
    (contrast the compile cache, which fails OPEN — a cold compile
    beats a dead host, but silently dropped state does not)."""

    def __init__(self, url: str, token: Optional[str] = None):
        from ..compile.aotcache import _parse_objstore_url
        from ..serve.objectstore import ObjectStoreClient

        endpoint, bucket, prefix = _parse_objstore_url(url)
        token = token or os.environ.get("DATAX_OBJSTORE_TOKEN")
        self.url = url
        self._client = ObjectStoreClient(endpoint, bucket, token=token)
        self._prefix = prefix

    def _key(self, prefix: str, *rest: str) -> str:
        parts = [p for p in (self._prefix, prefix) + rest if p]
        return "/".join(parts)

    def put_files(self, prefix: str, side: str,
                  files: Dict[str, bytes]) -> None:
        try:
            for fn, data in files.items():
                self._client.put(self._key(prefix, side, fn), data)
        except Exception as e:
            raise SnapshotStoreError(
                f"state snapshot push {prefix}/{side} failed: {e}"
            ) from e

    def get_file(self, prefix: str, side: str, name: str) -> Optional[bytes]:
        try:
            return self._client.get(self._key(prefix, side, name))
        except Exception as e:
            raise SnapshotStoreError(
                f"state snapshot pull {prefix}/{side}/{name} failed: {e}"
            ) from e

    def put_pointer(self, prefix: str, side: str) -> None:
        try:
            self._client.put(self._key(prefix, "pointer"), side.encode())
        except Exception as e:
            raise SnapshotStoreError(
                f"state pointer commit {prefix} failed: {e}"
            ) from e

    def get_pointer(self, prefix: str) -> Optional[str]:
        try:
            data = self._client.get(self._key(prefix, "pointer"))
        except Exception as e:
            raise SnapshotStoreError(
                f"state pointer read {prefix} failed: {e}"
            ) from e
        if data is None:
            return None
        p = data.decode("utf-8", "replace").strip()
        return p if p in SIDES else None


# ---------------------------------------------------------------------------
# Window snapshot split / merge
# ---------------------------------------------------------------------------
def snapshot_to_bytes(snap: Dict) -> bytes:
    """Serialize a window-state snapshot dict (the
    ``snapshot_window_state`` shape) to npz bytes — the per-partition
    payload the snapshot stores ship."""
    from .checkpoint import snapshot_arrays

    buf = io.BytesIO()
    np.savez(buf, **snapshot_arrays(snap))
    return buf.getvalue()


def snapshot_from_bytes(data: bytes) -> Dict:
    """Parse npz bytes back into a snapshot dict. Raises on a corrupt
    or truncated payload — the caller's cue to fall back to the
    standby side."""
    from .checkpoint import arrays_to_snapshot

    with np.load(io.BytesIO(data)) as z:
        return arrays_to_snapshot(z)


def split_window_snapshot(
    snap: Dict,
    partitions: int,
    key_cols: Dict[str, Tuple[str, str]],
    dictionary=None,
    only: Optional[Sequence[int]] = None,
) -> Dict[int, Dict]:
    """Split one window snapshot into per-partition snapshots.

    ``key_cols``: ring table -> (key column, kind). Rows of a table
    with no usable key column all land in partition 0 (documented —
    an unkeyed window can't follow a key-range handoff any finer).
    Each partition snapshot is COMPACTED to its member rows (re-packed
    per slot, capacity truncated to the widest slot) — the merge
    re-packs rows anyway, so the positions don't need to survive, and
    the mirror push ships O(member rows) per partition instead of P
    copies of the entire ring. The original ring capacity rides along
    as ``cap`` per table so the merge can rebuild the full shape."""
    want = set(int(p) for p in only) if only is not None else None
    targets = [
        p for p in range(partitions) if want is None or p in want
    ]
    out: Dict[int, Dict] = {
        p: {
            "rings": {},
            "slot_counter": snap.get("slot_counter", 0),
            "base_ms": snap.get("base_ms"),
            "dictionary": snap.get("dictionary"),
        }
        for p in targets
    }
    for table, ring in snap.get("rings", {}).items():
        valid = np.asarray(ring["valid"])
        cols = {c: np.asarray(a) for c, a in ring["cols"].items()}
        k_slots, cap = valid.shape
        kc = key_cols.get(table)
        pids = None
        if kc is not None and kc[0] in cols:
            pids = partition_ids(
                cols[kc[0]], partitions, kc[1], dictionary=dictionary,
            )
        for p in targets:
            if pids is not None:
                member = valid & (pids == p)
            else:
                member = valid if p == 0 else np.zeros_like(valid)
            new_cap = int(member.sum(axis=1).max()) if k_slots else 0
            p_cols = {
                c: np.zeros((k_slots, new_cap), dtype=a.dtype)
                for c, a in cols.items()
            }
            p_valid = np.zeros((k_slots, new_cap), dtype=bool)
            for k in range(k_slots):
                idx = np.nonzero(member[k])[0]
                n = int(idx.size)
                if n:
                    for c, a in cols.items():
                        p_cols[c][k, :n] = a[k][idx]
                    p_valid[k, :n] = True
            out[p]["rings"][table] = {
                "cols": p_cols, "valid": p_valid, "cap": int(cap),
            }
    return out


def merge_window_snapshots(
    parts: List[Dict],
    schema_types: Dict[str, Dict[str, str]],
    dictionary,
    ts_col: Optional[str],
) -> Optional[Dict]:
    """Merge per-partition window snapshots — possibly from SEVERAL
    predecessor replicas (a scale-down) — into one restorable snapshot.

    Rows are re-packed per ring slot (positions from different
    predecessors collide, so a positional union would lose rows),
    relative timestamps are rebased onto the newest predecessor's batch
    base, and string-typed ring ids are remapped through each source
    snapshot's OWN dictionary into the live one — the merged snapshot
    carries ``dictionary: None`` because its ids are already live.
    Rows past a slot's capacity are dropped oldest-last (counted in
    the returned snapshot's ``dropped_rows``)."""
    parts = [p for p in parts if p and p.get("rings")]
    if not parts:
        return None
    bases = [p.get("base_ms") for p in parts if p.get("base_ms") is not None]
    base_target = max(bases) if bases else None
    first = parts[0]["rings"]
    out_rings: Dict[str, Dict] = {}
    fill: Dict[str, np.ndarray] = {}
    for table, ring in first.items():
        # partition snapshots are compacted to their member rows
        # (split_window_snapshot); the FULL ring shape is rebuilt from
        # the ``cap`` each carries (whole, uncompacted snapshots fall
        # back to their own width)
        same = [
            p["rings"][table] for p in parts if table in p.get("rings", {})
        ]
        k_slots = max(np.asarray(r["valid"]).shape[0] for r in same)
        cap = max(
            int(r.get("cap", np.asarray(r["valid"]).shape[1]))
            for r in same
        )
        out_rings[table] = {
            "cols": {
                c: np.zeros((k_slots, cap), dtype=np.asarray(a).dtype)
                for c, a in ring["cols"].items()
            },
            "valid": np.zeros((k_slots, cap), dtype=bool),
        }
        fill[table] = np.zeros(k_slots, dtype=np.int64)
    dropped = 0
    for part in parts:
        delta = 0
        if base_target is not None and part.get("base_ms") is not None:
            delta = int(part["base_ms"]) - int(base_target)
        src_dict = part.get("dictionary")
        id_map: Dict[int, int] = {}
        if src_dict is not None:
            # source id i (1-based over entries) -> live id
            for i, s in enumerate(src_dict):
                id_map[i + 1] = dictionary.encode(s)
        for table, ring in part.get("rings", {}).items():
            if table not in out_rings:
                continue
            types = schema_types.get(table, {})
            dst = out_rings[table]
            valid = np.asarray(ring["valid"])
            k_slots = valid.shape[0]
            cap = dst["valid"].shape[1]  # room in the REBUILT ring,
            # not the source part's compacted width
            for k in range(min(k_slots, fill[table].shape[0])):
                idx = np.nonzero(valid[k])[0]
                if idx.size == 0:
                    continue
                n0 = int(fill[table][k])
                room = cap - n0
                if idx.size > room:
                    dropped += int(idx.size - room)
                    idx = idx[:room]
                n = idx.size
                if n == 0:
                    continue
                for c, a in ring["cols"].items():
                    if c not in dst["cols"]:
                        continue
                    vals = np.asarray(a)[k][idx]
                    if c == ts_col and delta:
                        vals = vals + np.int32(delta)
                    elif types.get(c) == "string" and id_map:
                        vals = np.array(
                            [id_map.get(int(v), 0) for v in vals],
                            dtype=np.asarray(a).dtype,
                        )
                    dst["cols"][c][k, n0:n0 + n] = vals
                dst["valid"][k, n0:n0 + n] = True
                fill[table][k] = n0 + n
    return {
        "rings": out_rings,
        "slot_counter": max(int(p.get("slot_counter", 0)) for p in parts),
        "base_ms": base_target,
        "dictionary": None,  # ids already remapped into the live dictionary
        "dropped_rows": dropped,
    }
