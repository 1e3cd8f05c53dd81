"""Schemas: Spark-style schema JSON -> flat typed column map.

Flow configs carry input schemas in Spark's JSON schema format
(e.g. HomeAutomationLocal.json ``inputSchemaFile``); we parse the same
format (reference: datax-host input/SchemaFile.scala loads it via Spark's
``DataType.fromJson``) but flatten nested structs into dotted column paths
— the device representation is struct-of-arrays, not row objects.

Column types on device (TPU-first, no x64):
- LONG    -> int32
- DOUBLE  -> float32
- BOOLEAN -> bool
- STRING  -> int32 dictionary id (host keeps the id<->str dictionary)
- TIMESTAMP -> int32 milliseconds relative to the batch's host-side
  ``base_ms`` (covers +-24 days per batch; absolute time is restored on
  the host at sink/metric boundaries)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np


class ColType(Enum):
    LONG = "long"
    DOUBLE = "double"
    BOOLEAN = "boolean"
    STRING = "string"
    TIMESTAMP = "timestamp"

    @property
    def np_dtype(self):
        return {
            ColType.LONG: np.int32,
            ColType.DOUBLE: np.float32,
            ColType.BOOLEAN: np.bool_,
            ColType.STRING: np.int32,
            ColType.TIMESTAMP: np.int32,
        }[self]


_SPARK_TYPE_MAP = {
    "long": ColType.LONG,
    "integer": ColType.LONG,
    "int": ColType.LONG,
    "short": ColType.LONG,
    "byte": ColType.LONG,
    "double": ColType.DOUBLE,
    "float": ColType.DOUBLE,
    "decimal": ColType.DOUBLE,
    "boolean": ColType.BOOLEAN,
    "string": ColType.STRING,
    "timestamp": ColType.TIMESTAMP,
    "date": ColType.TIMESTAMP,
}


@dataclass(frozen=True)
class Column:
    name: str  # dotted path, e.g. "deviceDetails.deviceId"
    ctype: ColType
    nullable: bool = True
    metadata: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Schema:
    columns: List[Column]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def has(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    # -- Spark schema JSON ----------------------------------------------
    @staticmethod
    def from_spark_json(text_or_obj) -> "Schema":
        obj = (
            json.loads(text_or_obj) if isinstance(text_or_obj, str) else text_or_obj
        )
        cols: List[Column] = []

        def walk(fields: list, prefix: str) -> None:
            for f in fields:
                name = prefix + f["name"]
                ftype = f.get("type", "string")
                if isinstance(ftype, dict) and ftype.get("type") == "struct":
                    walk(ftype["fields"], name + ".")
                    continue
                if isinstance(ftype, dict):
                    raise ValueError(
                        f"unsupported nested type for column {name}: {ftype.get('type')}"
                    )
                base = str(ftype).lower()
                if base.startswith("decimal"):
                    base = "decimal"
                if base not in _SPARK_TYPE_MAP:
                    raise ValueError(f"unsupported column type {ftype!r} for {name}")
                metadata = f.get("metadata") or {}
                ctype = _SPARK_TYPE_MAP[base]
                # long columns carrying epoch millis (marked
                # useCurrentTimeMillis, e.g. HomeAutomationLocal's
                # deviceDetails.eventTime) don't fit int32 — treat them as
                # TIMESTAMP so they get the relative-ms device encoding
                if ctype == ColType.LONG and metadata.get("useCurrentTimeMillis"):
                    ctype = ColType.TIMESTAMP
                cols.append(
                    Column(
                        name=name,
                        ctype=ctype,
                        nullable=bool(f.get("nullable", True)),
                        metadata=metadata,
                    )
                )

        if obj.get("type") != "struct":
            raise ValueError("schema root must be a struct")
        walk(obj.get("fields", []), "")
        return Schema(cols)

    def to_spark_json(self) -> dict:
        """Serialize back to (flattened) Spark schema JSON."""
        return {
            "type": "struct",
            "fields": [
                {
                    "name": c.name,
                    "type": c.ctype.value,
                    "nullable": c.nullable,
                    "metadata": c.metadata,
                }
                for c in self.columns
            ],
        }


class DictionaryFullError(RuntimeError):
    """Raised in strict mode when the string dictionary hits its
    configured capacity bound."""


class StringDictionary:
    """Host-side bidirectional string<->int32 id dictionary.

    One shared dictionary per job keeps ids stable across batches and
    columns, so device-side equality/grouping/joins on dictionary ids are
    exact string semantics (no hashing collisions). id 0 is reserved for
    null/missing.
    """

    NULL_ID = 0

    def __init__(self, max_size: Optional[int] = None, strict: bool = False):
        import threading

        self._to_id: Dict[str, int] = {}
        self._to_str: List[Optional[str]] = [None]  # id 0 -> null
        # encode is check-then-append: the decode-ahead ingest worker
        # and the main thread's aux-table build both insert, so the
        # write path must be serialized (reads stay lock-free — CPython
        # list/dict reads see a consistent prefix)
        self._write_lock = threading.Lock()
        # optional capacity bound (conf process.stringdictionary.maxsize):
        # a hostile/high-cardinality stream would otherwise grow the
        # dictionary — and every device lookup table derived from it —
        # without limit. Beyond the bound new strings encode to NULL and
        # are counted (overflow_count -> an ingest metric), or raise in
        # strict mode. Existing ids are never evicted: device state
        # (rings, state tables) holds ids across batches, so eviction
        # would corrupt history.
        self.max_size = max_size
        self.strict = strict
        self.overflow_count = 0

    def __len__(self) -> int:
        return len(self._to_str)

    def encode(self, s: Optional[str]) -> int:
        if s is None:
            return self.NULL_ID
        i = self._to_id.get(s)
        if i is not None:
            return i
        with self._write_lock:
            i = self._to_id.get(s)  # racer may have inserted it
            if i is not None:
                return i
            if self.max_size is not None and len(self._to_str) >= self.max_size:
                if self.strict:
                    raise DictionaryFullError(
                        f"string dictionary reached its configured bound "
                        f"({self.max_size}); new string {s!r} rejected "
                        "(datax.job.process.stringdictionary.strict=true)"
                    )
                self.overflow_count += 1
                return self.NULL_ID
            i = len(self._to_str)
            self._to_str.append(s)
            self._to_id[s] = i
            return i

    def entries(self) -> List[str]:
        """Every non-null entry in id order (id 1 first) — the snapshot
        a checkpoint persists so device-resident ids survive restarts."""
        return list(self._to_str[1:])

    def restore_entries(self, saved: List[str]) -> bool:
        """Replay a saved ``entries()`` list into this dictionary.

        The current contents (strings encoded during flow compile) must
        be a prefix of the saved list — same conf produces the same
        compile-time encodes in the same order — otherwise the saved ids
        would alias different strings and the restore is refused.

        Replay bypasses the capacity bound: these entries ARE prior
        state (device rings reference their ids), so an operator who
        lowered ``maxsize`` below the saved size must still get an exact
        restore — the bound applies to NEW strings only."""
        with self._write_lock:
            current = self._to_str[1:]
            if current != saved[: len(current)]:
                return False
            for s in saved[len(current):]:
                self._to_id[s] = len(self._to_str)
                self._to_str.append(s)
            return True

    def lookup(self, s: Optional[str]) -> int:
        """Encode without inserting; unseen strings get -1 (matches nothing)."""
        if s is None:
            return self.NULL_ID
        return self._to_id.get(s, -1)

    def decode(self, i: int) -> Optional[str]:
        if 0 <= i < len(self._to_str):
            return self._to_str[i]
        return None

    def decode_array(self, ids) -> List[Optional[str]]:
        return [self.decode(int(i)) for i in np.asarray(ids)]
