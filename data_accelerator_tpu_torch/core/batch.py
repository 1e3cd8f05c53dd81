"""Columnar micro-batch: the device-resident unit of streaming data.

Where the reference engine's unit is a Spark ``DataFrame`` of rows, the
unit here is a fixed-capacity struct-of-tensors with a validity mask
(reference hot path analog: CommonProcessorFactory.scala:333-399
processDataset). Static shapes keep every batch's work the same shape.

String columns hold int32 dictionary ids (see
``core.schema.StringDictionary``); timestamps are int32 ms since
``base_ms``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .schema import ColType, Schema, StringDictionary


@dataclass
class Batch:
    """Fixed-capacity columnar batch.

    columns: name -> [capacity] tensor (int32/float32/bool)
    valid:   [capacity] bool mask of live rows
    base_ms: epoch-ms origin for TIMESTAMP columns, carried as a 0-d
             float32 tensor of epoch seconds (seconds precision is
             enough for window/bookkeeping math on device).
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor
    base_ms: torch.Tensor  # 0-d float32: epoch seconds of the batch origin

    # -- basic props -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def count(self) -> torch.Tensor:
        """Number of live rows (0-d int32 tensor)."""
        return self.valid.sum(dtype=torch.int32)

    def with_columns(self, columns: Dict[str, torch.Tensor]) -> "Batch":
        return Batch(columns, self.valid, self.base_ms)

    def with_valid(self, valid: torch.Tensor) -> "Batch":
        return Batch(self.columns, valid, self.base_ms)

    def select(self, names: Sequence[str]) -> "Batch":
        return self.with_columns({n: self.columns[n] for n in names})


def empty_batch(schema: Schema, capacity: int, base_ms: float = 0.0,
                device: "torch.device | str" = "cpu") -> Batch:
    """A batch of ``capacity`` zero rows, none of them live, on ``device``."""
    cols = {
        c.name: torch.from_numpy(np.zeros((capacity,), dtype=c.ctype.np_dtype)).to(device)
        for c in schema.columns
    }
    return Batch(
        cols,
        torch.zeros((capacity,), dtype=torch.bool, device=device),
        torch.full((), base_ms / 1000.0, dtype=torch.float32, device=device),
    )


def batch_from_rows(
    rows: List[dict],
    schema: Schema,
    capacity: int,
    dictionary: StringDictionary,
    base_ms: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
    device: "torch.device | str" = "cpu",
) -> Batch:
    """Host-side encode of JSON-like row dicts into a batch on ``device``.

    Nested dicts are addressed by the schema's dotted paths. Rows beyond
    ``capacity`` are dropped (the runtime's ingest chunker prevents this).
    This is the pure-Python path; the JAX package's C++ decoder produces
    the same buffers for its hot ingest path.

    A row whose TIMESTAMP column holds an unparseable string is marked
    invalid (not silently anchored at the batch base time); pass
    ``stats`` to receive a ``bad_timestamps`` count for metrics.
    """
    n = min(len(rows), capacity)
    bad_ts = np.zeros((capacity,), dtype=np.bool_)
    if base_ms is None:
        base_ms = 0
        for r in rows[:n]:
            ts = _first_timestamp(r, schema)
            if ts is not None:
                base_ms = ts
                break

    arrays: Dict[str, np.ndarray] = {}
    for col in schema.columns:
        arr = np.zeros((capacity,), dtype=col.ctype.np_dtype)
        for i in range(n):
            v = _dig(rows[i], col.name)
            if v is None:
                continue
            if col.ctype == ColType.STRING:
                arr[i] = dictionary.encode(str(v))
            elif col.ctype == ColType.TIMESTAMP:
                if isinstance(v, str):
                    # string timestamps parse at the encode boundary —
                    # the role of the reference's stringToTimestamp
                    # built-in UDF (BuiltInFunctionsHandler); device
                    # columns never hold raw date strings
                    v = parse_timestamp_ms(v)
                    if v is None:
                        # garbage timestamp: excluding the row beats
                        # silently treating it as the batch base time
                        # (which would window it wrongly)
                        bad_ts[i] = True
                        continue
                # relative ms saturate at the int32 range: a sample/replay
                # row weeks away from the batch base clamps (~±24 days)
                # instead of overflowing
                arr[i] = np.int32(
                    max(-2**31, min(2**31 - 1, int(v) - base_ms))
                )
            elif col.ctype == ColType.BOOLEAN:
                arr[i] = bool(v)
            elif col.ctype == ColType.LONG:
                arr[i] = np.int32(int(v))
            else:
                arr[i] = np.float32(v)
        arrays[col.name] = arr

    valid = np.zeros((capacity,), dtype=np.bool_)
    valid[:n] = True
    valid &= ~bad_ts
    if stats is not None:
        stats["bad_timestamps"] = (
            stats.get("bad_timestamps", 0) + int(bad_ts.sum())
        )
    return Batch(
        {k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        torch.from_numpy(valid).to(device),
        torch.full((), base_ms / 1000.0, dtype=torch.float32, device=device),
    )


def batch_to_rows(
    batch: Batch,
    dictionary: StringDictionary,
    schema_types: Optional[Dict[str, ColType]] = None,
    max_rows: Optional[int] = None,
) -> List[dict]:
    """Device -> host rows (only valid rows), decoding dictionary ids and
    restoring absolute timestamps. Used by sinks and LiveQuery display."""
    host_cols = {k: v.detach().cpu().numpy() for k, v in batch.columns.items()}
    valid = batch.valid.detach().cpu().numpy()
    base_ms = int(round(float(batch.base_ms) * 1000.0))
    idx = np.nonzero(valid)[0]
    if max_rows is not None:
        idx = idx[:max_rows]
    types = schema_types or {}
    out = []
    for i in idx:
        row = {}
        for name, arr in host_cols.items():
            v = arr[i]
            ctype = types.get(name)
            if ctype == ColType.STRING:
                row[name] = dictionary.decode(int(v))
            elif ctype == ColType.TIMESTAMP:
                row[name] = int(v) + base_ms
            elif arr.dtype == np.bool_:
                row[name] = bool(v)
            elif np.issubdtype(arr.dtype, np.integer):
                row[name] = int(v)
            else:
                row[name] = float(v)
        out.append(row)
    return out


def _dig(obj: dict, dotted: str):
    cur = obj
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def parse_timestamp_ms(text: str) -> Optional[int]:
    """Parse a timestamp string to epoch ms (stringToTimestamp role).

    Accepts ISO-8601 (T or space separator, optional fraction/Z) and
    bare epoch seconds/millis digits; returns None on garbage."""
    from datetime import datetime, timezone

    s = text.strip()
    if not s:
        return None
    if s.replace(".", "", 1).isdigit():
        num = float(s)
        return int(num if num > 1e12 else num * 1000.0)
    try:
        t = datetime.fromisoformat(s.replace("Z", "+00:00").replace(" ", "T"))
    except ValueError:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return int(t.timestamp() * 1000)


def _first_timestamp(row: dict, schema: Schema) -> Optional[int]:
    for col in schema.columns:
        if col.ctype == ColType.TIMESTAMP:
            v = _dig(row, col.name)
            if isinstance(v, str):
                v = parse_timestamp_ms(v)  # unparseable -> fall through
            if v is not None:
                return int(v)
    return None
