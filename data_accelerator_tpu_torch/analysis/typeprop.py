"""Type lattice + expression checker for the flow static analyzer.

Copy of the JAX package's ``analysis/typeprop.py``, untrimmed. It
also exports ``BUILTIN_FNS``, which ``udf/api.py`` reads to refuse a
UDF that a builtin would shadow.

A deliberately small lattice — ``numeric | string | bool | timestamp |
unknown`` — seeded from the flow's Spark-style input schemas (the same
JSON ``serve/schemainference.py`` emits) and propagated through each
statement's select list. ``unknown`` is the top element: anything the
checker cannot prove stays unknown and produces **no** diagnostics, so
the analyzer can never be more strict than the runtime compiler
(``compile/exprs.py``), only earlier.

The checker walks expressions once doing double duty: reference
resolution (pass 1 codes) and type propagation (pass 2), plus the
aggregation-context and device-tier checks that are per-expression
properties (DX020/DX041/DX042).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..compile.sqlparser import (
    BinOp,
    CaseWhen,
    Cast,
    Col,
    Expr,
    Func,
    InList,
    IsNull,
    LikeOp,
    Literal,
    Star,
    UnaryOp,
)

NUMERIC = "numeric"
STRING = "string"
BOOL = "bool"
TIMESTAMP = "timestamp"
UNKNOWN = "unknown"

# Spark schema field type -> lattice type
_SPARK_TYPES = {
    "long": NUMERIC, "int": NUMERIC, "integer": NUMERIC, "bigint": NUMERIC,
    "short": NUMERIC, "byte": NUMERIC, "double": NUMERIC, "float": NUMERIC,
    "decimal": NUMERIC,
    "boolean": BOOL,
    "string": STRING,
    "timestamp": TIMESTAMP, "date": TIMESTAMP,
}

# state-table DDL type -> lattice type ("deviceId long, peak double")
DDL_TYPES = dict(_SPARK_TYPES)


def schema_to_types(schema_json) -> Optional[Dict[str, str]]:
    """Spark ``{"type":"struct","fields":[...]}`` -> {column: lattice type}.

    Returns None when the schema is absent/unparseable — callers treat
    that as an *open* table (any column resolves, typed unknown).
    """
    if not schema_json:
        return None
    try:
        schema = (
            json.loads(schema_json) if isinstance(schema_json, str)
            else schema_json
        )
        fields = schema["fields"]
    except (ValueError, KeyError, TypeError):
        return None
    out: Dict[str, str] = {}
    for f in fields:
        try:
            t = f["type"]
            name = f["name"]
        except (KeyError, TypeError):
            return None
        out[name] = (
            _SPARK_TYPES.get(t, UNKNOWN) if isinstance(t, str) else UNKNOWN
        )
    return out


def ddl_to_types(ddl: str) -> Optional[Dict[str, str]]:
    """``"deviceId long, peak double"`` -> {column: lattice type}."""
    out: Dict[str, str] = {}
    for part in ddl.split(","):
        toks = part.split()
        if len(toks) < 2:
            return None
        out[toks[0].strip("`")] = DDL_TYPES.get(toks[1].lower(), UNKNOWN)
    return out


@dataclass
class TypeInfo:
    """Lattice type + whether the value is a computed (deferred) string."""

    type: str = UNKNOWN
    computed_string: bool = False


@dataclass
class TableScope:
    """One table's design-time shape. ``types=None`` = open table: its
    columns are unknowable (custom normalization snippet, unparseable
    upstream) so member lookups succeed with type unknown."""

    name: str
    types: Optional[Dict[str, str]] = None
    # output columns carry computed-string flags across views
    computed: frozenset = frozenset()

    @property
    def open(self) -> bool:
        return self.types is None

    def lookup(self, col: str) -> Optional[TypeInfo]:
        if self.types is None:
            return TypeInfo(UNKNOWN)
        if col in self.types:
            return TypeInfo(self.types[col], col in self.computed)
        return None


# ---------------------------------------------------------------------------
# Builtin function surface (compile/exprs.py) grouped by result type.
# Unknown-but-declared UDFs type as unknown; a name in neither set is a
# dangling reference (DX006).
# ---------------------------------------------------------------------------
from ..compile.exprs import AGGREGATE_FNS  # {"AVG","MIN","MAX","SUM","COUNT"}

_STRING_RESULT_FNS = {
    "UPPER", "UCASE", "LOWER", "LCASE", "TRIM", "LTRIM", "RTRIM", "REVERSE",
    "INITCAP", "SUBSTRING", "SUBSTR", "REPLACE", "TRANSLATE", "REPEAT",
    "LPAD", "RPAD", "SPLIT_PART", "REGEXP_EXTRACT", "REGEXP_REPLACE",
    "ELEMENT_AT", "FROM_UNIXTIME", "TO_DATE",
}
_NUMERIC_RESULT_FNS = {
    "LENGTH", "CHAR_LENGTH", "CHARACTER_LENGTH", "LEN", "INSTR", "LOCATE",
    "ASCII", "UNIX_TIMESTAMP", "TO_UNIX_TIMESTAMP", "HOUR", "MINUTE",
    "SECOND", "YEAR", "MONTH", "DAY", "DAYOFMONTH", "DAYOFWEEK", "DATEDIFF",
    "POW", "POWER", "MOD", "SIGN", "ABS", "FLOOR", "CEIL", "ROUND", "SQRT",
    "EXP", "LOG", "LOG2", "LOG10",
}
_BOOL_RESULT_FNS = {"CONTAINS", "STARTSWITH", "STARTS_WITH", "ENDSWITH",
                    "ENDS_WITH"}
_TIMESTAMP_RESULT_FNS = {"CURRENT_TIMESTAMP", "DATE_TRUNC", "TO_TIMESTAMP",
                         "STRINGTOTIMESTAMP"}
_COMPOSITE_FNS = {"MAP", "STRUCT", "ARRAY", "FILTERNULL", "SPLIT",
                  "COALESCE", "IF", "GREATEST", "LEAST", "APPLYTEMPLATE"}
# string ops whose dictionary tables are keyed on a constant argument:
# {name: 1-based positions that must be literals}
_CONST_ARG_FNS = {
    "SUBSTRING": (2, 3), "SUBSTR": (2, 3), "REPLACE": (2, 3),
    "TRANSLATE": (2, 3), "INSTR": (2,), "CONTAINS": (2,),
    "STARTSWITH": (2,), "STARTS_WITH": (2,), "ENDSWITH": (2,),
    "ENDS_WITH": (2,), "REGEXP_EXTRACT": (2, 3), "REGEXP_REPLACE": (2, 3),
    "REPEAT": (2,), "LPAD": (2, 3), "RPAD": (2, 3), "SPLIT_PART": (2, 3),
    "LOCATE": (1, 3),
}
# string ops that gather through a per-distinct-string dictionary table
# and therefore reject computed (deferred) string inputs (DX042)
_DICT_TABLE_FNS = (
    _STRING_RESULT_FNS - {"ELEMENT_AT", "FROM_UNIXTIME", "TO_DATE"}
) | {"LENGTH", "CHAR_LENGTH", "CHARACTER_LENGTH", "LEN", "INSTR", "LOCATE",
     "ASCII"} | _BOOL_RESULT_FNS

BUILTIN_FNS = (
    AGGREGATE_FNS | _STRING_RESULT_FNS | _NUMERIC_RESULT_FNS
    | _BOOL_RESULT_FNS | _TIMESTAMP_RESULT_FNS | _COMPOSITE_FNS
    | {"CONCAT", "CONCAT_WS", "CAST"}
)

# comparison pairs that cannot both be right at design time (everything
# else is coercible or too close to call)
_INCOMPATIBLE = {
    frozenset((STRING, NUMERIC)), frozenset((STRING, BOOL)),
    frozenset((STRING, TIMESTAMP)), frozenset((BOOL, TIMESTAMP)),
    frozenset((BOOL, NUMERIC)),
}

_CMP_OPS = {"=", "!=", "<", "<=", ">", ">="}
_ARITH_OPS = {"+", "-", "*", "/", "%"}


def incompatible(a: str, b: str) -> bool:
    return frozenset((a, b)) in _INCOMPATIBLE


def _literal_type(lit: Literal) -> str:
    return {"int": NUMERIC, "float": NUMERIC, "str": STRING,
            "bool": BOOL, "null": UNKNOWN}[lit.kind]


_CAST_NUMERIC = {"LONG", "INT", "INTEGER", "BIGINT", "DOUBLE", "FLOAT"}


@dataclass
class SelectScope:
    """FROM/JOIN bindings of one statement: binding -> TableScope."""

    bindings: List[Tuple[str, TableScope]] = field(default_factory=list)

    def add(self, binding: str, table: TableScope) -> None:
        self.bindings.append((binding, table))

    @property
    def any_open(self) -> bool:
        return any(t.open for _, t in self.bindings)

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[Optional[TypeInfo], bool]:
        """Resolve a (possibly qualified / struct-pathed) column.

        Returns (info, definite_miss): info is None when unresolved;
        definite_miss is True only when every candidate table is closed,
        so the miss is reportable without false-positive risk.
        """
        # table-qualified: first part names a binding
        if len(parts) > 1:
            for b, t in self.bindings:
                if b == parts[0]:
                    info = t.lookup(parts[1])
                    return info, not t.open
        # bare (or struct path rooted at a column): search all bindings
        hits = []
        for _, t in self.bindings:
            info = t.lookup(parts[0])
            if info is not None:
                hits.append(info)
        if hits:
            # struct member access types as unknown beyond the root
            return (hits[0] if len(parts) == 1 else TypeInfo(UNKNOWN)), False
        return None, not self.any_open


class ExprChecker:
    """Single-walk resolver + typer for one statement.

    ``emit(code, message, col_offset)`` receives pass-1/2/3/5 findings;
    the caller owns span construction (statement line + offset).
    """

    def __init__(
        self,
        scope: SelectScope,
        udfs: frozenset,
        emit: Callable[[str, str], None],
    ):
        self.scope = scope
        self.udfs = udfs  # upper-cased declared UDF/UDAF names
        self.emit = emit

    # -- entry points ----------------------------------------------------
    def check(self, e: Expr, agg_allowed: bool) -> TypeInfo:
        return self._type(e, agg_allowed)

    # -- walk ------------------------------------------------------------
    def _type(self, e: Expr, agg: bool) -> TypeInfo:
        if isinstance(e, Literal):
            return TypeInfo(_literal_type(e))
        if isinstance(e, Star):
            return TypeInfo(UNKNOWN)
        if isinstance(e, Col):
            info, definite = self.scope.resolve(e.parts)
            if info is None:
                if definite:
                    self.emit("DX002", f"unknown column '{e.dotted}'")
                return TypeInfo(UNKNOWN)
            return info
        if isinstance(e, Cast):
            return self._cast(e, agg)
        if isinstance(e, Func):
            return self._func(e, agg)
        if isinstance(e, BinOp):
            return self._binop(e, agg)
        if isinstance(e, UnaryOp):
            inner = self._type(e.operand, agg)
            if e.op == "NOT":
                return TypeInfo(BOOL)
            return TypeInfo(inner.type if inner.type == NUMERIC else UNKNOWN)
        if isinstance(e, InList):
            item = self._type(e.expr, agg)
            for opt in e.options:
                t = self._type(opt, agg)
                if incompatible(item.type, t.type):
                    self.emit(
                        "DX010",
                        f"IN list item type {t.type} does not match "
                        f"{item.type} operand",
                    )
            return TypeInfo(BOOL)
        if isinstance(e, IsNull):
            self._type(e.expr, agg)
            return TypeInfo(BOOL)
        if isinstance(e, LikeOp):
            arg = self._type(e.expr, agg)
            if not (isinstance(e.pattern, Literal) and e.pattern.kind == "str"):
                self.emit(
                    "DX041",
                    "LIKE/RLIKE pattern must be a string literal — the "
                    "predicate compiles to a per-distinct-string dictionary "
                    "table keyed on the pattern",
                )
            else:
                self._type(e.pattern, agg)
            if arg.computed_string:
                self.emit(
                    "DX042",
                    "LIKE/RLIKE over a computed string (CONCAT/CAST result) "
                    "has no device tier",
                )
            return TypeInfo(BOOL)
        if isinstance(e, CaseWhen):
            out = TypeInfo(UNKNOWN)
            for cond, val in e.whens:
                self._type(cond, agg)
                out = self._type(val, agg)
            if e.otherwise is not None:
                out2 = self._type(e.otherwise, agg)
                if out.type == UNKNOWN:
                    out = out2
            return TypeInfo(out.type, out.computed_string)
        return TypeInfo(UNKNOWN)

    def _cast(self, e: Cast, agg: bool) -> TypeInfo:
        inner = self._type(e.expr, agg)
        target = e.target
        if isinstance(e.expr, Literal) and e.expr.kind == "str" \
                and target in _CAST_NUMERIC:
            try:
                float(e.expr.value)
            except (TypeError, ValueError):
                self.emit(
                    "DX012",
                    f"CAST('{e.expr.value}' AS {target}) cannot convert",
                )
        if target in ("STRING", "VARCHAR"):
            # stringifying a non-string is a deferred host computation
            return TypeInfo(STRING, computed_string=inner.type != STRING)
        if target in _CAST_NUMERIC:
            return TypeInfo(NUMERIC)
        if target == "BOOLEAN":
            return TypeInfo(BOOL)
        if target == "TIMESTAMP":
            return TypeInfo(TIMESTAMP)
        return TypeInfo(UNKNOWN)

    def _binop(self, e: BinOp, agg: bool) -> TypeInfo:
        lt = self._type(e.left, agg)
        rt = self._type(e.right, agg)
        if e.op in ("AND", "OR"):
            return TypeInfo(BOOL)
        if e.op in _CMP_OPS:
            if incompatible(lt.type, rt.type):
                self.emit(
                    "DX010",
                    f"comparing {lt.type} {e.op} {rt.type}",
                )
            return TypeInfo(BOOL)
        if e.op in _ARITH_OPS:
            for side in (lt, rt):
                if side.type in (STRING, BOOL):
                    self.emit(
                        "DX010",
                        f"arithmetic '{e.op}' over a {side.type} operand",
                    )
            return TypeInfo(NUMERIC)
        return TypeInfo(UNKNOWN)

    def _func(self, e: Func, agg: bool) -> TypeInfo:
        name = e.name
        if name in AGGREGATE_FNS:
            if not agg:
                self.emit(
                    "DX020",
                    f"aggregate {name}() outside an aggregation context",
                )
            arg_t = TypeInfo(NUMERIC)
            # aggregate args are themselves scalar context
            for a in e.args:
                if not isinstance(a, Star):
                    arg_t = self._type(a, False)
            if name in ("MIN", "MAX"):
                return TypeInfo(arg_t.type)
            return TypeInfo(NUMERIC)

        # constant-argument positions (dictionary-table keyed)
        const_pos = _CONST_ARG_FNS.get(name, ())
        arg_infos: List[TypeInfo] = []
        for i, a in enumerate(e.args, start=1):
            info = self._type(a, agg)
            arg_infos.append(info)
            if i in const_pos and not isinstance(a, Literal):
                self.emit(
                    "DX041",
                    f"{name} argument {i} must be a literal — the string "
                    "table is keyed on it",
                )
        if name in _DICT_TABLE_FNS and arg_infos \
                and arg_infos[0].computed_string:
            self.emit(
                "DX042",
                f"{name} over a computed string (CONCAT/CAST result) has "
                "no device tier",
            )

        if name in ("CONCAT", "CONCAT_WS"):
            return TypeInfo(STRING, computed_string=True)
        if name in _STRING_RESULT_FNS:
            return TypeInfo(STRING)
        if name in _NUMERIC_RESULT_FNS:
            return TypeInfo(NUMERIC)
        if name in _BOOL_RESULT_FNS:
            return TypeInfo(BOOL)
        if name in _TIMESTAMP_RESULT_FNS:
            return TypeInfo(TIMESTAMP)
        if name in _COMPOSITE_FNS:
            if name == "IF" and len(e.args) == 3:
                return TypeInfo(arg_infos[1].type if len(arg_infos) > 1
                                else UNKNOWN)
            if name in ("COALESCE", "GREATEST", "LEAST") and arg_infos:
                return TypeInfo(arg_infos[0].type)
            return TypeInfo(UNKNOWN)
        if name in self.udfs:
            return TypeInfo(UNKNOWN)
        self.emit(
            "DX006",
            f"unknown function {name}() — not an engine builtin and not "
            "declared under gui.process.functions",
        )
        return TypeInfo(UNKNOWN)
