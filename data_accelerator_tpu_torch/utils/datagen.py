"""Random event generation from an input schema.

Powers the local "one-box" simulated source and load generation for
benchmarks — the analog of the reference's schema-driven random JSON
generator (datax-utility DataGenerator.scala:18-160, consumed by
input/LocalStreamingSource.scala:19-41) and the SimulatedData service
(DataX.SimulatedData DataGen.cs:41-54).

Honored schema field metadata (same keys as the reference):
``allowedValues``, ``minValue``/``maxValue``, ``maxLength``,
``useCurrentTimeMillis``.

Copy of the JAX package's ``utils/datagen.py``, unchanged; the port's
``LocalSource`` draws its simulated events from it.
"""

from __future__ import annotations

import random
import string
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.schema import ColType, Schema, StringDictionary

DEFAULT_MAX_LENGTH = 10


class DataGenerator:
    def __init__(self, schema: Schema, seed: Optional[int] = None):
        self.schema = schema
        self.rng = random.Random(seed)

    def random_row(self, now_ms: Optional[int] = None) -> dict:
        """One event as a nested dict matching the schema's dotted paths."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        row: dict = {}
        for col in self.schema.columns:
            value = self._random_value(col.ctype, col.metadata, now_ms)
            _bury(row, col.name, value)
        return row

    def random_rows(self, n: int, now_ms: Optional[int] = None) -> List[dict]:
        return [self.random_row(now_ms) for _ in range(n)]

    def _random_value(self, ctype: ColType, md: dict, now_ms: int):
        rng = self.rng
        allowed = md.get("allowedValues")
        if ctype == ColType.STRING:
            if allowed:
                return str(rng.choice(allowed))
            max_len = int(md.get("maxLength", DEFAULT_MAX_LENGTH))
            return "".join(
                rng.choice(string.ascii_letters + string.digits)
                for _ in range(max_len)
            )
        if ctype == ColType.BOOLEAN:
            return rng.random() < 0.5
        if ctype == ColType.DOUBLE:
            if allowed:
                return float(rng.choice(allowed))
            lo = float(md.get("minValue", 0.0))
            hi = float(md.get("maxValue", 1.0))
            return rng.uniform(lo, hi)
        # LONG / TIMESTAMP: useCurrentTimeMillis wins, then allowedValues,
        # then min/max (reference: DataGenerator.scala long handling)
        if md.get("useCurrentTimeMillis") or ctype == ColType.TIMESTAMP:
            return now_ms
        if allowed:
            return int(rng.choice(allowed))
        lo = int(md.get("minValue", 0))
        hi = int(md.get("maxValue", 1000))
        return rng.randint(lo, max(lo, hi))

    # -- vectorized fast path (bench/ingest-rate testing) ---------------
    def random_columns(
        self,
        n: int,
        dictionary: StringDictionary,
        now_ms: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Directly generate encoded column arrays (no per-row dicts) —
        the high-rate path for benchmarks, bypassing JSON entirely."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        nprng = np.random.default_rng(seed)
        cols: Dict[str, np.ndarray] = {}
        for col in self.schema.columns:
            md = col.metadata
            allowed = md.get("allowedValues")
            if col.ctype == ColType.STRING:
                if allowed:
                    ids = np.array([dictionary.encode(str(v)) for v in allowed])
                    cols[col.name] = ids[nprng.integers(0, len(ids), n)].astype(
                        np.int32
                    )
                else:
                    cols[col.name] = np.full(
                        n, dictionary.encode("x"), dtype=np.int32
                    )
            elif col.ctype == ColType.TIMESTAMP or md.get("useCurrentTimeMillis"):
                cols[col.name] = np.zeros(n, dtype=np.int32)  # == base_ms
            elif col.ctype == ColType.BOOLEAN:
                cols[col.name] = nprng.integers(0, 2, n).astype(np.bool_)
            elif col.ctype == ColType.DOUBLE:
                if allowed:
                    vals = np.asarray(allowed, dtype=np.float32)
                    cols[col.name] = vals[nprng.integers(0, len(vals), n)]
                else:
                    lo = float(md.get("minValue", 0.0))
                    hi = float(md.get("maxValue", 1.0))
                    cols[col.name] = nprng.uniform(lo, hi, n).astype(np.float32)
            else:
                if allowed:
                    vals = np.asarray(allowed, dtype=np.int32)
                    cols[col.name] = vals[nprng.integers(0, len(vals), n)]
                else:
                    lo = int(md.get("minValue", 0))
                    hi = int(md.get("maxValue", 1000))
                    cols[col.name] = nprng.integers(lo, max(lo, hi) + 1, n).astype(
                        np.int32
                    )
        return cols


def _bury(obj: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = obj
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value
