"""Device-side string operations via dictionary lookup tables.

Strings live on device as int32 dictionary ids (core/schema.py
StringDictionary). The reference evaluates string functions row-by-row
inside Spark SQL (``spark.sql`` at CommonProcessorFactory.scala:257);
the TPU-native equivalent computes each string expression ONCE PER
DISTINCT STRING on the host — as a lookup table over the dictionary —
and the device applies it as a single int32 gather per row:

- ``map``    tables: string -> string   (UPPER, TRIM, SUBSTRING, ...)
             id -> id of the result string (result strings are encoded
             into the shared dictionary, so downstream equality /
             GROUP BY / JOIN on transformed strings stay exact)
- ``pred``   tables: string -> boolean  (LIKE, RLIKE, CONTAINS, ...)
- ``scalar`` tables: string -> int32    (LENGTH, INSTR, ...)
- ``rank`` / ``unrank``: the sort permutation of the dictionary,
             enabling string ORDER BY, range comparisons (< > <= >=)
             and MIN/MAX aggregates with exact lexicographic semantics.

The tables are ordinary tensor inputs of the per-batch step (shape = a
power-of-two capacity >= dictionary size), refreshed incrementally on
the host as the dictionary grows and copied to the device only when it
did — amortized, since dictionaries converge for real streams. This is
dramatically cheaper than per-row string processing: the host does
O(new distinct strings) Python-level work per batch, the device does O(rows) int32 gathers on data that stays in HBM.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.schema import StringDictionary

logger = logging.getLogger(__name__)

# table value kinds -> numpy dtype
_KIND_DTYPE = {
    "map": np.int32,     # result string id
    "pred": np.bool_,    # predicate result
    "scalar": np.int32,  # integer result
}

# keys reserved for the ordering tables
RANK_KEY = "__rank"
UNRANK_KEY = "__unrank"

# keys reserved for the computed-string hash tables. A deferred string
# (CONCAT/CAST result) has no dictionary id, but equality/grouping/joins
# only need a device value that discriminates strings: a polynomial
# rolling hash composes over concatenation —
#   H_p(a + b) = H_p(a) * p^len(b) + H_p(b)   (mod 2^32)
# so per-id tables of H_p(s) and p^len(s) let the device compute the
# hash of any concatenation with one multiply-add per part. TWO
# independent hashes (different odd multipliers) are compared together,
# making an accidental collision a ~2^-64 event — the practical price of
# keeping computed strings fully device-resident (the dictionary stays
# exact for plain string columns).
HASH1_KEY = "__strhash1"
HASH2_KEY = "__strhash2"
PLEN1_KEY = "__strplen1"
PLEN2_KEY = "__strplen2"
HASH_P1 = 1000003
HASH_P2 = 92821

_MASK32 = (1 << 32) - 1


def _wrap_i32(v: int) -> int:
    """uint32 bits as the int32 value numpy will accept (device integer
    arithmetic wraps, so int32 bit patterns compose identically)."""
    v &= _MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def poly_hash(s: str, p: int) -> int:
    h = 0
    for ch in s:
        h = (h * p + ord(ch) + 1) & _MASK32
    return _wrap_i32(h)


def pow_len(s: str, p: int) -> int:
    return _wrap_i32(pow(p, len(s), 1 << 32))


def register_strhash(registry: "AuxRegistry") -> None:
    """Register the four computed-string hash tables."""
    registry.register(HASH1_KEY, "scalar", lambda s: poly_hash(s, HASH_P1))
    registry.register(HASH2_KEY, "scalar", lambda s: poly_hash(s, HASH_P2))
    registry.register(PLEN1_KEY, "scalar", lambda s: pow_len(s, HASH_P1))
    registry.register(PLEN2_KEY, "scalar", lambda s: pow_len(s, HASH_P2))

# default bound on image-cascade rounds when building map tables:
# functions whose results are new strings (which then need their own
# mapping, e.g. REPLACE(REPLACE(x))) converge within a couple of rounds
# for real flows; pathological self-growing chains stop at the bound,
# which is configurable per flow (``process.stringmap.maxrounds``) along
# with a strict mode (``process.stringmap.strict``) that fails loud
# instead of leaving unconverged entries NULL
_MAX_ROUNDS = 4


@dataclass(frozen=True)
class AuxSpec:
    """One host-computed dictionary table."""

    key: str                 # stable identity (function + const args)
    kind: str                # "map" | "pred" | "scalar"
    fn: Callable[[str], object]  # host fn over a non-null string


class AuxRegistry:
    """Compile-time collection of the dictionary tables a pipeline needs.

    Shared by every ExprCompiler/SelectCompiler of one flow so identical
    subexpressions (same function + same constant args) share a table.
    """

    def __init__(self):
        self.specs: Dict[str, AuxSpec] = {}
        self.needs_rank = False

    def register(self, key: str, kind: str, fn: Callable[[str], object]) -> str:
        if key not in self.specs:
            self.specs[key] = AuxSpec(key, kind, fn)
        return key

    def require_rank(self) -> None:
        self.needs_rank = True

    @property
    def empty(self) -> bool:
        return not self.specs and not self.needs_rank


def _pow2_capacity(n: int, minimum: int = 1024) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class AuxTableBuilder:
    """Maintains the host-side numpy tables for a registry + dictionary.

    ``tables()`` returns ``{key: torch.Tensor}`` on ``device``, sized to
    the current
    power-of-two capacity; map/pred/scalar tables extend incrementally
    (already-computed entries never change), rank tables recompute fully
    whenever the dictionary grew (ranks are global).
    """

    def __init__(
        self,
        registry: AuxRegistry,
        dictionary: StringDictionary,
        *,
        max_rounds: int = _MAX_ROUNDS,
        strict: bool = False,
        device: "torch.device | str" = "cpu",
    ):
        self.device = torch.device(device)
        self.registry = registry
        self.dictionary = dictionary
        self.max_rounds = max_rounds
        self.strict = strict
        self._np: Dict[str, np.ndarray] = {}
        self._filled = 0          # entries computed per incremental table
        self._built_len = -1      # dictionary length at last build
        self._device: Optional[Dict[str, object]] = None

    # -- host-side table maintenance --------------------------------------
    def _extend_incremental(self) -> None:
        """Compute table entries for dictionary ids added since last call.

        Encoding a map's result strings can itself add dictionary
        entries (whose own mappings are then needed if maps compose on
        device); iterate until the dictionary stops growing or the
        round bound hits.
        """
        d = self.dictionary
        specs = [s for s in self.registry.specs.values()]
        rounds = 0
        while self._filled < len(d) and rounds < self.max_rounds:
            rounds += 1
            start, end = self._filled, len(d)
            # decode once per new id, apply every spec
            strings = [d.decode(i) for i in range(start, end)]
            for spec in specs:
                vals = np.zeros(end - start, dtype=_KIND_DTYPE[spec.kind])
                for j, s in enumerate(strings):
                    if s is None:
                        # null string: map->null id, pred->False, scalar->0
                        continue
                    try:
                        r = spec.fn(s)
                    except Exception:  # noqa: BLE001 — per-entry host fn
                        r = None
                    if r is None:
                        continue
                    if spec.kind == "map":
                        vals[j] = d.encode(str(r))
                    elif spec.kind == "pred":
                        vals[j] = bool(r)
                    else:
                        vals[j] = int(r)
                prev = self._np.get(spec.key)
                if prev is None or len(prev) < end:
                    grown = np.zeros(
                        _pow2_capacity(len(d)), dtype=_KIND_DTYPE[spec.kind]
                    )
                    if prev is not None:
                        grown[: len(prev)] = prev
                    self._np[spec.key] = grown
                self._np[spec.key][start:end] = vals
            self._filled = end
        if self._filled < len(self.dictionary):
            # every batch that leaves entries unmapped is reported (the
            # set of affected strings changes batch to batch), with a
            # sample of the strings that will evaluate to NULL
            sample = [
                repr(self.dictionary.decode(i))
                for i in range(self._filled, min(self._filled + 5, len(d)))
            ]
            msg = (
                f"string-map cascade did not converge in {self.max_rounds} "
                f"rounds ({self._filled} of {len(self.dictionary)} "
                f"dictionary entries mapped); unconverged entries evaluate "
                f"to NULL, e.g. {', '.join(sample)} — raise "
                f"datax.job.process.stringmap.maxrounds"
            )
            if self.strict:
                from ..core.config import EngineException
                raise EngineException(msg)
            logger.warning(
                "%s, or set datax.job.process.stringmap.strict=true to "
                "fail loud", msg
            )

    def _build_rank(self, capacity: int) -> None:
        """Full lexicographic rank of every dictionary entry.

        None (id 0) ranks first, matching SQL NULLS FIRST on ascending
        order. rank is a permutation of [0, len); unrank inverts it.
        """
        d = self.dictionary
        n = len(d)
        entries = [(d.decode(i) or "", i != 0, i) for i in range(n)]
        # null first, then lexicographic
        order = sorted(range(n), key=lambda i: (entries[i][1], entries[i][0]))
        rank = np.zeros(capacity, dtype=np.int32)
        unrank = np.zeros(capacity, dtype=np.int32)
        for r, i in enumerate(order):
            rank[i] = r
            unrank[r] = i
        self._np[RANK_KEY] = rank
        self._np[UNRANK_KEY] = unrank

    def tables(self) -> Dict[str, object]:
        """Current device tables (tensors), rebuilt only on growth."""
        if self.registry.empty:
            return {}
        if self._device is not None and self._built_len == len(self.dictionary):
            return self._device
        self._extend_incremental()
        capacity = _pow2_capacity(len(self.dictionary))
        out: Dict[str, object] = {}
        for key in self.registry.specs:
            tbl = self._np[key]
            if len(tbl) < capacity:
                grown = np.zeros(capacity, dtype=tbl.dtype)
                grown[: len(tbl)] = tbl
                self._np[key] = tbl = grown
            out[key] = self._to_device(tbl[:capacity])
        if self.registry.needs_rank:
            self._build_rank(capacity)
            out[RANK_KEY] = self._to_device(self._np[RANK_KEY])
            out[UNRANK_KEY] = self._to_device(self._np[UNRANK_KEY])
        # record what was actually COMPUTED (_filled), not the current
        # dictionary length: a decode-ahead ingest thread may append
        # entries between the extend above and here, and marking those
        # as built would leave their table slots 0/NULL forever
        self._built_len = self._filled
        self._device = out
        return out

    def _to_device(self, table: np.ndarray) -> torch.Tensor:
        # a copy: the host table keeps growing in place
        return torch.from_numpy(np.array(table, copy=True)).to(self.device)


# ---------------------------------------------------------------------------
# Host implementations of the SQL string function library.
#
# Each builder returns (key, host_fn). Semantics follow Spark SQL (the
# engine the reference delegates to, CommonProcessorFactory.scala:257):
# 1-based positions, SUBSTRING clamping, LIKE with % and _.
# ---------------------------------------------------------------------------
def like_to_regex(pattern: str) -> str:
    """SQL LIKE pattern -> anchored regex (% = .*, _ = ., rest literal)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


def spark_substring(s: str, pos: int, length: Optional[int]) -> str:
    """Spark SUBSTRING: 1-based; pos<=0 counts from the end when
    negative, pos==0 behaves like 1; length clamps."""
    n = len(s)
    if pos > 0:
        start = pos - 1
    elif pos < 0:
        start = max(0, n + pos)
    else:
        start = 0
    if length is None:
        return s[start:]
    if length <= 0:
        return ""
    return s[start : start + length]


def spark_instr(s: str, sub: str) -> int:
    """1-based position of the first occurrence; 0 if absent."""
    return s.find(sub) + 1


def spark_split_at(s: str, delim_regex: str, index: int) -> Optional[str]:
    """element_at(split(s, d), i): 1-based, negative from end; None OOB."""
    parts = re.split(delim_regex, s) if delim_regex else list(s)
    if index == 0:
        return None
    i = index - 1 if index > 0 else len(parts) + index
    if 0 <= i < len(parts):
        return parts[i]
    return None
