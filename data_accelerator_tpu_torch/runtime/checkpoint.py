"""Offset checkpointing with the reference's file semantics.

reference: datax-host checkpoint/EventhubCheckpointer.scala:13-74 —
``offsets.txt`` holds one line per partition
``<ts>,<source>,<partition>,<fromSeq>,<untilSeq>``; before each write the
previous file is copied to ``offsets.txt.old``; on (re)start offsets are
read (falling back to the .old backup) and applied as starting positions.
At-least-once: a crash between sink write and checkpoint replays the
last batch.

Copy of the JAX package's ``runtime/checkpoint.py``, unchanged: the
window file stays ``np.savez`` in the same layout, so each package
restores the other's ``window.npz``.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..obs.tracing import span as _trace_span


def _durable_replace(tmp: str, dst: str) -> None:
    """``os.replace`` with power-loss durability: fsync the temp file
    before the rename (data hits the platter, not just the page cache)
    and fsync the directory after it (the rename itself is a directory
    entry). Without both, a crash-then-power-loss can surface a zero
    -length or missing checkpoint even though the process "wrote" it."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst)
    dir_fd = os.open(os.path.dirname(dst) or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def snapshot_arrays(snap: Dict) -> Dict:
    """Flatten a window-state snapshot dict
    (``FlowProcessor.snapshot_window_state`` shape) into the named
    numpy arrays one ``np.savez`` call persists. Shared by the
    whole-file checkpoint below and the per-partition payloads the
    state-partition stores ship (runtime/statepartition.py)."""
    import json as _json

    import numpy as np

    arrays: Dict = {}
    for table, ring in snap.get("rings", {}).items():
        for c, a in ring["cols"].items():
            arrays[f"ring/{table}/col/{c}"] = a
        arrays[f"ring/{table}/valid"] = ring["valid"]
        if ring.get("cap") is not None:
            # compacted partition snapshots carry the original ring
            # capacity so the merge can rebuild the full shape
            arrays[f"ring/{table}/cap"] = np.asarray(
                int(ring["cap"]), np.int64
            )
    arrays["slot_counter"] = np.asarray(int(snap.get("slot_counter", 0)),
                                        np.int64)
    base = snap.get("base_ms")
    arrays["base_ms"] = np.asarray(-1 if base is None else int(base),
                                   np.int64)
    if snap.get("dictionary") is not None:
        # ring ids are meaningless without the dictionary that encoded
        # them; ride it along as JSON bytes
        arrays["dictionary_json"] = np.frombuffer(
            _json.dumps(snap["dictionary"]).encode("utf-8"), dtype=np.uint8
        )
    return arrays


def arrays_to_snapshot(z) -> Dict:
    """Inverse of ``snapshot_arrays`` over a loaded npz mapping."""
    import json as _json

    rings: Dict[str, Dict] = {}
    for key in z.files:
        if not key.startswith("ring/"):
            continue
        _, table, kind = key.split("/", 2)
        ring = rings.setdefault(table, {"cols": {}, "valid": None})
        if kind == "valid":
            ring["valid"] = z[key]
        elif kind == "cap":
            ring["cap"] = int(z[key])
        else:
            ring["cols"][kind.split("/", 1)[1]] = z[key]
    base = int(z["base_ms"])
    out = {
        "rings": rings,
        "slot_counter": int(z["slot_counter"]),
        "base_ms": None if base < 0 else base,
    }
    if "dictionary_json" in z.files:
        out["dictionary"] = _json.loads(
            z["dictionary_json"].tobytes().decode("utf-8")
        )
    return out


@dataclass(frozen=True)
class PartitionOffset:
    ts_ms: int
    source: str
    partition: int
    from_seq: int
    until_seq: int


class OffsetCheckpointer:
    FILE = "offsets.txt"
    BACKUP = "offsets.txt.old"

    def __init__(self, checkpoint_dir: str):
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.dir, self.FILE)

    @property
    def backup_path(self) -> str:
        return os.path.join(self.dir, self.BACKUP)

    def write_offsets(self, offsets: List[PartitionOffset]) -> None:
        """Backup then write, as the reference does (scala :43-61) —
        fsynced so the checkpoint survives power loss, not just a
        process crash."""
        if os.path.exists(self.path):
            shutil.copyfile(self.path, self.backup_path)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for o in offsets:
                f.write(
                    f"{o.ts_ms},{o.source},{o.partition},{o.from_seq},{o.until_seq}\n"
                )
            f.flush()
            os.fsync(f.fileno())
        _durable_replace(tmp, self.path)

    def read_offsets(self) -> List[PartitionOffset]:
        """Read current file, falling back to the backup (scala :63-73)."""
        for path in (self.path, self.backup_path):
            if os.path.exists(path):
                try:
                    return self._parse(path)
                except Exception:
                    continue
        return []

    @staticmethod
    def _parse(path: str) -> List[PartitionOffset]:
        out = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                ts, source, part, from_seq, until_seq = line.split(",")
                out.append(
                    PartitionOffset(
                        int(ts), source, int(part), int(from_seq), int(until_seq)
                    )
                )
        return out

    def starting_positions(self) -> Dict[Tuple[str, int], int]:
        """(source, partition) -> next sequence number to read."""
        return {
            (o.source, o.partition): o.until_seq for o in self.read_offsets()
        }

    def checkpoint_batch(
        self, consumed: Dict[Tuple[str, int], Tuple[int, int]]
    ) -> None:
        """consumed: (source, partition) -> (from_seq, until_seq)."""
        with _trace_span("checkpoint/offsets"):
            now = int(time.time() * 1000)
            merged: Dict[Tuple[str, int], PartitionOffset] = {
                (o.source, o.partition): o for o in self.read_offsets()
            }
            for (source, part), (from_seq, until_seq) in consumed.items():
                merged[(source, part)] = PartitionOffset(
                    now, source, part, from_seq, until_seq
                )
            self.write_offsets(list(merged.values()))


class WindowStateCheckpointer:
    """Persist/restore the device window ring buffers across restarts.

    The offsets file above only replays the LAST batch; TIMEWINDOW ring
    buffers hold up to window+watermark of history that a restart would
    otherwise silently zero. The reference keeps that state in the Spark
    StreamingContext checkpoint (datax-host host/StreamingHost.scala:83-89
    ``StreamingContext.getOrCreate(checkpointDir, ...)``); here the rings
    are plain arrays, so the snapshot is one ``window.npz`` written with
    the same atomic-replace + ``.old`` backup semantics as offsets.txt.

    Serialized layout (all numpy): per ring table
    ``ring/<table>/col/<name>`` + ``ring/<table>/valid``, plus the slot
    counter and the time base the ring's relative timestamps refer to.
    """

    FILE = "window.npz"
    BACKUP = "window.npz.old"

    def __init__(self, checkpoint_dir: str):
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.dir, self.FILE)

    @property
    def backup_path(self) -> str:
        return os.path.join(self.dir, self.BACKUP)

    def save(self, snap: Dict) -> None:
        """snap: FlowProcessor.snapshot_window_state() output."""
        with _trace_span("checkpoint/window"):
            self._save(snap)

    def _save(self, snap: Dict) -> None:
        import numpy as np

        arrays = snapshot_arrays(snap)
        if os.path.exists(self.path):
            shutil.copyfile(self.path, self.backup_path)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        _durable_replace(tmp, self.path)

    def load(self) -> Optional[Dict]:
        """Restore a snapshot dict, falling back to the backup; None when
        no (readable) snapshot exists — including when a crash left only
        a torn ``window.npz.tmp`` behind (the tmp is never read; the
        previous complete checkpoint wins)."""
        import numpy as np

        for path in (self.path, self.backup_path):
            if not os.path.exists(path):
                continue
            try:
                with np.load(path) as z:
                    return arrays_to_snapshot(z)
            except Exception:
                continue
        return None
