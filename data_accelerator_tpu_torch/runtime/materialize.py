"""Device table -> host rows: the sink/display boundary.

Decodes dictionary ids back to strings, restores absolute timestamps from
the batch base, renders deferred string templates (CONCAT et al.), and
folds flattened struct/array columns back into nested JSON values —
producing the same row JSON the reference's sinks serialize
(OutputManager.scala:103-126 to_json(struct(cols))).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compile.exprs import WS_MARKER
from ..compile.planner import TableData, ViewSchema
from ..core.schema import StringDictionary
from ..native import jsonl


def _render_value(v, t: str, dictionary: StringDictionary, base_ms: int):
    if t == "string":
        return dictionary.decode(int(v))
    if t == "timestamp":
        return int(v) + base_ms
    if t == "tssec":
        return int(v) + base_ms // 1000
    if t == "boolean":
        return bool(v)
    if t == "double":
        return float(v)
    return int(v)


def materialize_rows(
    table: TableData,
    schema: ViewSchema,
    dictionary: StringDictionary,
    base_ms: int = 0,
    max_rows: Optional[int] = None,
) -> List[dict]:
    """Valid rows as JSON-ready dicts with nested structs re-assembled.
    ``table`` holds host data: numpy arrays or CPU tensors."""
    cols = {k: np.asarray(v) for k, v in table.cols.items()}
    valid = np.asarray(table.valid)
    idx = np.nonzero(valid)[0]
    if max_rows is not None:
        idx = idx[:max_rows]

    # organize flattened names into nesting groups
    device_cols = [
        c for c in schema.types if not c.startswith("__defer.")
    ]

    out: List[dict] = []
    for i in idx:
        row: dict = {}
        for c in device_cols:
            if c.endswith(".__valid"):
                continue
            v = _render_value(cols[c][i], schema.types[c], dictionary, base_ms)
            _bury(row, c, v)
        # deferred string templates. CONCAT: a NULL part nulls the
        # whole result (matching the device hash tier). CONCAT_WS
        # (WS_MARKER-tagged): null ARGUMENTS are skipped and the rest
        # join on the separator — both per Spark semantics.
        for name, parts in schema.deferred.items():
            ws_sep = None
            if parts and isinstance(parts[0], str) \
                    and parts[0].startswith(WS_MARKER):
                ws_sep = parts[0][len(WS_MARKER):]
                parts = parts[1:]
            pieces = []
            for p in parts:
                if isinstance(p, str):
                    pieces.append(p)
                    continue
                hidden, t = p
                rendered = _render_value(
                    cols[hidden][i], t, dictionary, base_ms
                )
                if rendered is None:
                    if ws_sep is not None:
                        continue  # concat_ws skips null arguments
                    pieces = None
                    break
                pieces.append(
                    f"{rendered:g}" if t == "double" else str(rendered)
                )
            if pieces is None:
                value = None
            elif ws_sep is not None:
                value = ws_sep.join(pieces)
            else:
                value = "".join(pieces)
            _bury(row, name, value)
        # array/struct validity: drop nulled-out branches
        row = _apply_validity(row, cols, schema, i)
        out.append(row)
    return out


def _apply_validity(row: dict, cols, schema: ViewSchema, i: int) -> dict:
    """Remove subtrees whose ``__valid`` flag is False; collapse arrays
    (numeric-keyed dicts) into lists of surviving elements."""
    valid_flags = {
        c[: -len(".__valid")]: bool(cols[c][i])
        for c in schema.types
        if c.endswith(".__valid")
    }

    def prune(obj, path: str):
        if not isinstance(obj, dict):
            return obj
        if path in valid_flags and not valid_flags[path]:
            return None
        keys = list(obj.keys())
        if keys and all(k.isdigit() for k in keys):
            items = []
            for k in sorted(keys, key=int):
                sub = prune(obj[k], f"{path}.{k}" if path else k)
                if sub is not None:
                    items.append(sub)
            return items
        out = {}
        for k in keys:
            sub = prune(obj[k], f"{path}.{k}" if path else k)
            if sub is not None or (f"{path}.{k}" if path else k) not in valid_flags:
                out[k] = sub
        return out

    return {k: prune(v, k) for k, v in row.items()}


def _bury(obj: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = obj
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


class LandedTable:
    """One output dataset of a landed batch: its valid rows compacted
    into numpy columns the table owns, so it outlives the transfer
    buffers they were copied from. ``rows()`` materializes the row
    dicts on first call and keeps them; a flat table (``flat``) also
    renders straight to JSON lines (``jsonl``), with no row dict built.

    Not a list: ``json.dumps`` and C code read a list's internals, and
    would find a subclass empty."""

    def __init__(
        self, cols: Dict[str, np.ndarray], n_rows: int, schema: ViewSchema,
        dictionary: StringDictionary, base_ms: int = 0,
        host_order: Optional[Sequence[Tuple[str, bool]]] = None,
        host_limit: Optional[int] = None,
    ):
        self.cols = cols
        self.schema = schema
        self.dictionary = dictionary
        self.base_ms = base_ms
        self.host_order = host_order
        self.host_limit = host_limit
        self._n = n_rows if host_limit is None else min(n_rows, host_limit)
        self._n_landed = n_rows
        self._rows: Optional[List[dict]] = None
        self._lock = threading.Lock()

    @classmethod
    def compact(
        cls, table: TableData, schema: ViewSchema,
        dictionary: StringDictionary, base_ms: int = 0,
        host_order: Optional[Sequence[Tuple[str, bool]]] = None,
        host_limit: Optional[int] = None,
    ) -> "LandedTable":
        """The valid rows of ``table`` (host arrays, which may be views
        of buffers a later batch reuses) copied into arrays of its own."""
        valid = np.asarray(table.valid)
        idx = np.nonzero(valid)[0]
        cols = {}
        for c, v in table.cols.items():
            v = np.asarray(v)
            cols[c] = v[idx] if v.shape[:1] == valid.shape else v.copy()
        return cls(cols, int(idx.size), schema, dictionary, base_ms,
                   host_order, host_limit)

    def __len__(self) -> int:
        return self._n

    def rows(self) -> List[dict]:
        """The rows as ``materialize_rows`` makes them, host-ordered and
        limited where the view says so; built once."""
        with self._lock:
            if self._rows is None:
                rows = materialize_rows(
                    TableData(self.cols, np.ones(self._n_landed, bool)),
                    self.schema, self.dictionary, self.base_ms,
                )
                if self.host_order:
                    _host_sort(rows, self.host_order)
                if self.host_limit is not None:
                    rows = rows[: self.host_limit]
                self._rows = rows
            return self._rows

    @property
    def flat(self) -> bool:
        """Whether ``jsonl`` renders this table: undotted columns of
        scalar types in dtypes that render as the row path does, no
        deferred templates, no host order or limit."""
        types = self.schema.types
        return bool(types) and not self.schema.deferred \
            and not self.host_order and self.host_limit is None and all(
                "." not in c
                and jsonl.column_kind(t, self.cols[c].dtype) is not None
                for c, t in types.items()
            )

    def jsonl(self) -> str:
        """The rows as JSON lines, each ending in a newline, rendered
        natively from the columns of a ``flat`` table."""
        names = list(self.schema.types)
        return jsonl.render(
            names, [self.schema.types[c] for c in names],
            [self.cols[c] for c in names], self._n, self.dictionary,
            self.base_ms,
        )


def _host_sort(rows: List[dict], order: Sequence[Tuple[str, bool]]) -> None:
    """Stable multi-key in-place sort matching SQL semantics: ascending
    puts NULLs first, descending puts them last (Spark defaults).
    Applied least-significant key first so significance composes."""
    for key, asc in reversed(order):
        def kf(r, k=key):
            v = r.get(k)
            # the second element only compares within equal null-flags,
            # so the placeholder never meets a real value
            return (v is not None, v if v is not None else 0)

        rows.sort(key=kf, reverse=not asc)
