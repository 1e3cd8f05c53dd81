"""Typed expression compilation: SQL AST -> torch tensor programs.

Every expression compiles to a ``CompiledExpr`` whose ``fn(env)`` returns
a tensor on the flow's device; ``env`` is an ``EvalEnv`` carrying the in-scope column
arrays and the batch time context. Plan-level types extend the storage
types with time encodings and composite values:

- "long"/"double"/"boolean"/"string": as in core.schema (string = dict id)
- "timestamp": int32 ms relative to the batch base (whole-second base)
- "tssec":     int32 s  relative to the batch base (unix_timestamp math)
- StructValue: named fields (MAP with literal keys / STRUCT)
- ArrayValue:  fixed-length element list (Array/filterNull), elements may
  carry validity (IF(cond, x, NULL))
- HostStr:     deferred host-side string computation (CONCAT etc.) — the
  device carries its input columns; the string materializes on the host
  at sink/display time for the (few) surviving rows.

Time design: the device never sees absolute epochs wider than int32.
``base_s`` (int32 epoch seconds, whole-second) and ``now_rel_ms`` (int32)
come in as 0-d int32 tensors, so absolute-time functions (hour(),
DATE_TRUNC) are exact integer math. reference analog: Spark SQL evaluates
these on JVM longs; the contract (same results) is preserved, the
representation is TPU-first.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.config import EngineException
from ..core.schema import StringDictionary
from .sqlparser import (
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
from .stringops import (
    RANK_KEY,
    AuxRegistry,
    like_to_regex,
    spark_instr,
    spark_split_at,
    spark_substring,
)

AGGREGATE_FNS = {"AVG", "MIN", "MAX", "SUM", "COUNT"}

# x64 is off in the reference: every integer plan type is int32 and
# double is float32
_DTYPES = {
    "long": torch.int32,
    "double": torch.float32,
    "boolean": torch.bool,
    "string": torch.int32,
    "timestamp": torch.int32,
    "tssec": torch.int32,
}

_MASK32 = (1 << 32) - 1


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 with the same low 32 bits (the
    wrap-around XLA's int32 arithmetic gives)."""
    x = x & _MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _full(env: "EvalEnv", value, dtype) -> torch.Tensor:
    return torch.full(env.shape, value, dtype=dtype, device=env.device)


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ids clamped into range, as a JAX gather clamps
    them (a torch index out of range raises, on CUDA fatally)."""
    return table[ids.clamp(0, table.shape[0] - 1).long()]


def _trunc_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.fmod``: truncated modulo; an integer divisor of 0 gives 0
    (the JAX CPU result), where torch would raise or be undefined."""
    if a.is_floating_point():
        return torch.fmod(a, b)
    zero = b == 0
    return torch.where(zero, 0, torch.fmod(a, torch.where(zero, 1, b))).to(a.dtype)


@dataclass
class EvalEnv:
    """Columns in scope + time context, all tensors on one device."""

    # binding -> {column dotted name -> tensor}
    scopes: Dict[str, Dict[str, torch.Tensor]]
    base_s: torch.Tensor  # 0-d int32 epoch seconds (whole second)
    now_rel_ms: torch.Tensor  # 0-d int32: "now" relative to base
    shape: Tuple[int, ...] = ()  # row-shape for literal broadcasting

    @property
    def device(self) -> torch.device:
        return self.base_s.device

    def column(self, binding: str, name: str) -> torch.Tensor:
        return self.scopes[binding][name]


@dataclass
class CompiledExpr:
    type: str  # "long" | "double" | "boolean" | "string" | "timestamp" | "tssec"
    fn: Callable[[EvalEnv], torch.Tensor]
    # source column dependencies (binding, column) — used for DISTINCT on
    # deferred strings and for join-side analysis
    deps: Tuple[Tuple[str, str], ...] = ()


@dataclass
class StructValue:
    fields: Dict[str, "Value"]
    validity: Optional[CompiledExpr] = None  # IF(cond, struct, NULL)


@dataclass
class ArrayValue:
    elements: List["Value"]


# reserved literal prefix marking a CONCAT_WS deferred template: the
# marker part carries the separator, every following part is ONE
# argument (null arguments are skipped at materialization, Spark
# concat_ws semantics). "\x00" cannot occur in user literals.
WS_MARKER = "\x00ws:"


@dataclass
class HostStr:
    """Deferred string expression: parts are literal strs or CompiledExpr
    whose device value gets decoded/stringified on the host at sink time.
    A first part starting with ``WS_MARKER`` switches the template to
    concat_ws (skip-null) rendering."""

    parts: List[Union[str, CompiledExpr]]
    deps: Tuple[Tuple[str, str], ...] = ()


Value = Union[CompiledExpr, StructValue, ArrayValue, HostStr]


def is_device(v: Value) -> bool:
    return isinstance(v, CompiledExpr)


def _int_str_hash(n: torch.Tensor, p: int):
    """Rolling hash of ``str(n)`` computed ON DEVICE for int32 ``n`` —
    the tier that makes ``CONCAT(..., CAST(n AS STRING))`` first-class
    (stringified numerics have unbounded value space, so no dictionary
    table can cover them; their decimal rendering is integer math).

    Returns ``(H_p(str(n)), p^len(str(n)))`` as int32 bit patterns,
    matching ``stringops.poly_hash``/``pow_len`` of the host rendering
    exactly. Torch has no uint32 ``//`` or ``%`` on the CPU, so the
    uint32 math runs in int64 masked to 32 bits; the magnitude of
    INT32_MIN survives there too."""
    u = n.to(torch.int64) & _MASK32
    neg = n < 0
    a = torch.where(neg, (-u) & _MASK32, u)
    ndigits = torch.ones(a.shape, dtype=torch.int64, device=a.device)
    for k in range(1, 10):
        ndigits = ndigits + (a >= 10 ** k).to(torch.int64)
    # chars are '-' then most-significant digit first: walk fixed 10
    # digit slots, folding only the active ones
    h = torch.where(neg, ord("-") + 1, 0).to(torch.int64)
    pu = p & _MASK32
    for i in range(9, -1, -1):
        digit = (a // 10 ** i) % 10
        folded = (h * pu + (ord("0") + 1 + digit)) & _MASK32
        h = torch.where(ndigits > i, folded, h)
    # p^len (len includes the sign char) from 12 constants, selected
    # without a host-to-device table copy
    length = ndigits + neg.to(torch.int64)
    plen = torch.ones_like(length)
    for k in range(2, 12):
        plen = torch.where(length == k, pow(p, k, 1 << 32), plen)
    plen = torch.where(length == 1, p & _MASK32, plen)
    return _wrap_i32(h), _wrap_i32(plen)


# ---------------------------------------------------------------------------
# Name resolution
# ---------------------------------------------------------------------------
@dataclass
class Scope:
    """Resolution scope: bindings (table aliases) -> column name -> type.

    Column values may be plan types (str) or composite Values for columns
    that are themselves deferred (HostStr passthrough).
    """

    tables: Dict[str, Dict[str, str]]  # binding -> {col -> type}
    deferred: Dict[str, Dict[str, HostStr]] = field(default_factory=dict)

    def resolve(self, parts: Sequence[str]) -> Tuple[str, str]:
        """Resolve a dotted reference to (binding, column_name).

        Rules (covering the reference flows' usage):
        1. if parts[0] is a binding, resolve the remainder inside it;
        2. otherwise search all bindings for an exact dotted match, then a
           unique dot-boundary suffix match (``deviceId`` matches
           ``deviceDetails.deviceId``).
        """
        dotted = ".".join(parts)
        if parts[0] in self.tables and len(parts) > 1:
            binding = parts[0]
            rest = ".".join(parts[1:])
            col = self._match_in(binding, rest)
            if col is not None:
                return binding, col
            if rest in self.deferred.get(binding, {}):
                return binding, rest
            # fall through: maybe "deviceDetails.deviceId" where
            # deviceDetails coincides with nothing
        candidates: List[Tuple[str, str]] = []
        for binding in self.tables:
            col = self._match_in(binding, dotted)
            if col is not None:
                candidates.append((binding, col))
        # deferred (computed-string) columns resolve by exact name
        for binding, dcols in self.deferred.items():
            if dotted in dcols:
                candidates.append((binding, dotted))
        if len(candidates) == 1:
            return candidates[0]
        if len(candidates) > 1:
            # a join scope's merged "" binding subsumes the per-table
            # bindings (it exists exactly so unqualified names resolve
            # once); prefer it
            merged = [c for c in candidates if c[0] == ""]
            if len(merged) == 1:
                return merged[0]
            # then prefer exact-name matches over suffix matches
            exact = [c for c in candidates if c[1] == dotted]
            if len(exact) == 1:
                return exact[0]
            raise EngineException(
                f"ambiguous column reference '{dotted}' across {sorted(t for t, _ in candidates)}"
            )
        raise EngineException(
            f"cannot resolve column '{dotted}' in scope "
            f"{ {b: sorted(cols) for b, cols in self.tables.items()} }"
        )

    def _match_in(self, binding: str, dotted: str) -> Optional[str]:
        cols = self.tables[binding]
        if dotted in cols:
            return dotted
        suffix_matches = [c for c in cols if c.endswith("." + dotted)]
        if len(suffix_matches) == 1:
            return suffix_matches[0]
        if len(suffix_matches) > 1:
            raise EngineException(
                f"ambiguous column suffix '{dotted}' in table '{binding}': {suffix_matches}"
            )
        return None

    def type_of(self, binding: str, col: str) -> str:
        return self.tables[binding][col]


# ---------------------------------------------------------------------------
# Numeric promotion helpers
# ---------------------------------------------------------------------------
def _promote(a: str, b: str) -> str:
    if a == b:
        return a
    numeric_rank = {"boolean": 0, "long": 1, "tssec": 1, "timestamp": 1, "double": 2}
    if a in numeric_rank and b in numeric_rank:
        return "double" if numeric_rank[a] == 2 or numeric_rank[b] == 2 else "long"
    raise EngineException(f"cannot combine types {a} and {b}")


def _to_dtype(arr: torch.Tensor, t: str) -> torch.Tensor:
    return arr.to(_DTYPES[t])


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt; the real cube root keeps the sign
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# Expression compiler
# ---------------------------------------------------------------------------
class ExprCompiler:
    """Compile AST expressions against a Scope.

    ``udfs``: name -> UDF object (udf/api.py) for the torch UDF tiers; host UDFs (str -> str) come through the registry and
    produce HostStr values.
    """

    def __init__(
        self,
        scope: Scope,
        dictionary: StringDictionary,
        udfs: Optional[dict] = None,
        aux: Optional[AuxRegistry] = None,
    ):
        self.scope = scope
        self.dictionary = dictionary
        self.udfs = udfs or {}
        # UDF objects this compiler's expressions actually called — the
        # select compiler attributes them to the view's StagePlan so
        # the mesh partition planner knows which stages embed custom
        # kernels the SPMD partitioner cannot shard
        self.called_udfs: list = []
        # dictionary-table registry for device string ops; shared across
        # every compiler of one flow (see compile/stringops.py)
        self.aux = aux if aux is not None else AuxRegistry()

    # -- public ----------------------------------------------------------
    def compile(self, e: Expr) -> Value:
        if isinstance(e, Literal):
            return self._literal(e)
        if isinstance(e, Col):
            return self._column(e)
        if isinstance(e, BinOp):
            return self._binop(e)
        if isinstance(e, UnaryOp):
            return self._unary(e)
        if isinstance(e, Func):
            return self._func(e)
        if isinstance(e, Cast):
            return self._cast(e)
        if isinstance(e, InList):
            return self._in_list(e)
        if isinstance(e, CaseWhen):
            return self._case(e)
        if isinstance(e, IsNull):
            return self._is_null(e)
        if isinstance(e, LikeOp):
            return self._like(e)
        if isinstance(e, Star):
            raise EngineException("* only allowed as a top-level select item")
        raise EngineException(f"unsupported expression {e!r}")

    def compile_device(self, e: Expr, what: str = "expression") -> CompiledExpr:
        v = self.compile(e)
        if not is_device(v):
            raise EngineException(
                f"{what} must be device-computable, got deferred/composite: {e!r}"
            )
        return v

    # -- leaves ----------------------------------------------------------
    def _literal(self, e: Literal) -> Value:
        if e.kind == "str":
            sid = self.dictionary.encode(e.value)
            return CompiledExpr(
                "string",
                lambda env, sid=sid: _full(env, sid, torch.int32),
            )
        if e.kind == "null":
            # bare NULL only appears inside IF(cond, x, NULL); handled there
            return CompiledExpr(
                "long", lambda env: _full(env, 0, torch.int32)
            )
        if e.kind == "bool":
            return CompiledExpr(
                "boolean",
                lambda env, v=e.value: _full(env, bool(v), torch.bool),
            )
        if e.kind == "float":
            return CompiledExpr(
                "double",
                lambda env, v=e.value: _full(env, v, torch.float32),
            )
        return CompiledExpr(
            "long",
            lambda env, v=e.value: _full(env, v, torch.int32),
        )

    def _column(self, e: Col) -> Value:
        binding, col = self.scope.resolve(e.parts)
        deferred = self.scope.deferred.get(binding, {})
        if col in deferred:
            h = deferred[col]
            return HostStr(list(h.parts), h.deps)
        t = self.scope.type_of(binding, col)
        return CompiledExpr(
            t,
            lambda env, b=binding, c=col: env.column(b, c),
            deps=((binding, col),),
        )

    # -- operators -------------------------------------------------------
    def _binop(self, e: BinOp) -> Value:
        op = e.op
        if op in ("AND", "OR"):
            l = self.compile_device(e.left, "boolean operand")
            r = self.compile_device(e.right, "boolean operand")
            f = torch.logical_and if op == "AND" else torch.logical_or
            return CompiledExpr(
                "boolean",
                lambda env, l=l, r=r, f=f: f(l.fn(env), r.fn(env)),
                deps=l.deps + r.deps,
            )

        lv = self.compile(e.left)
        rv = self.compile(e.right)
        if op in ("=", "!=") and (
            isinstance(lv, HostStr) or isinstance(rv, HostStr)
        ):
            # computed strings (CONCAT/CAST results) compare via the
            # device hash tier instead of dictionary ids
            return self._deferred_equality(op, lv, rv, e)

        l = self._as_device_value(lv, e.left)
        r = self._as_device_value(rv, e.right)

        if op in ("=", "!=", "<", "<=", ">", ">="):
            return self._comparison(op, l, r)
        return self._arith(op, l, r)

    def _as_device(self, e: Expr) -> CompiledExpr:
        return self._as_device_value(self.compile(e), e)

    def _as_device_value(self, v: Value, e: Expr) -> CompiledExpr:
        if isinstance(v, HostStr):
            raise EngineException(
                "deferred string expressions (CONCAT/CAST-to-string results) "
                f"cannot be used in device computation: {e!r}"
            )
        if not is_device(v):
            raise EngineException(f"composite value not usable here: {e!r}")
        return v

    # -- computed-string device keys --------------------------------------
    def hash_keys(self, v: Value) -> Optional[List[CompiledExpr]]:
        """Device key triple ``[h1, h2, isnull]`` for a string value.

        Gives deferred strings (CONCAT/CAST-to-string results) a
        first-class device tier for equality / GROUP BY / JOIN: two
        independent rolling hashes compose over concatenation via the
        per-id hash/p^len tables (see stringops.register_strhash), so a
        computed string never needs a dictionary id to participate in
        device comparisons. ``CAST(<long> AS STRING)`` parts have
        unbounded value space — no table can cover them — but their
        decimal rendering is pure integer math, so the device computes
        the rolling hash of the digit string directly (see
        ``_int_str_hash``). Returns None when ``v`` is not a string or
        contains parts with no device tier (CAST of double — float
        formatting is not device math; CONCAT_WS — skip-null breaks the
        rolling-hash composition).

        reference parity: the reference composes string expressions
        freely because Spark SQL evaluates them row-by-row
        (CommonProcessorFactory.scala:257); this is the TPU-resident
        equivalent for the equality-class uses.
        """
        from .stringops import (
            HASH1_KEY,
            HASH2_KEY,
            HASH_P1,
            HASH_P2,
            PLEN1_KEY,
            PLEN2_KEY,
            poly_hash,
            pow_len,
            register_strhash,
        )

        if is_device(v) and v.type == "string":
            parts: List[Union[str, CompiledExpr]] = [v]
        elif isinstance(v, HostStr):
            if v.parts and isinstance(v.parts[0], str) \
                    and v.parts[0].startswith(WS_MARKER):
                # concat_ws skips null arguments — a rolling hash over
                # fixed parts cannot express that; no device tier
                return None
            parts = []
            for p in v.parts:
                if isinstance(p, str):
                    parts.append(p)
                elif is_device(p) and p.type in ("string", "long"):
                    # long: CAST(n AS STRING) — digit hash computed on
                    # device (_int_str_hash); other types have no exact
                    # device rendering (double formatting, timestamp
                    # patterns) and fall back to host-only
                    parts.append(p)
                else:
                    return None
        else:
            return None
        register_strhash(self.aux)
        deps = tuple(
            d
            for p in parts
            if not isinstance(p, str)
            for d in p.deps
        )

        def null_of(env, parts=parts):
            n = _full(env, False, torch.bool)
            for p in parts:
                # only STRING parts can be null (id 0); a long part's 0
                # is the number zero, which stringifies to "0"
                if not isinstance(p, str) and p.type == "string":
                    n = n | (p.fn(env) == 0)
            return n

        def make(hkey, pkey, hp):
            consts = [
                (poly_hash(p, hp), pow_len(p, hp))
                if isinstance(p, str) else None
                for p in parts
            ]

            def run(env, parts=parts, consts=consts, hkey=hkey, pkey=pkey,
                    hp=hp):
                th = env.scopes["__aux"][hkey]
                tq = env.scopes["__aux"][pkey]
                # int32 wrap-around, computed in int64 and masked
                h_acc = torch.zeros(env.shape, dtype=torch.int64, device=env.device)
                for p, c in zip(parts, consts):
                    if c is not None:
                        # H(a+lit) = H(a)*p^len(lit) + H(lit), int32 wrap
                        h_acc = (h_acc * c[1] + c[0]) & _MASK32
                    elif p.type == "string":
                        ids = p.fn(env)
                        h_acc = (
                            h_acc * _gather(tq, ids).to(torch.int64)
                            + _gather(th, ids).to(torch.int64)
                        ) & _MASK32
                    else:
                        # stringified integer: hash of the decimal
                        # rendering, computed in uint32 device math
                        ph, pl = _int_str_hash(p.fn(env), hp)
                        h_acc = (
                            h_acc * pl.to(torch.int64) + ph.to(torch.int64)
                        ) & _MASK32
                # a NULL part nulls the whole string; zero the hash so
                # every null row carries the same key (SQL groups NULLs
                # together)
                return torch.where(null_of(env), 0, _wrap_i32(h_acc))

            return CompiledExpr("long", run, deps=deps)

        return [
            make(HASH1_KEY, PLEN1_KEY, HASH_P1),
            make(HASH2_KEY, PLEN2_KEY, HASH_P2),
            CompiledExpr("boolean", null_of, deps=deps),
        ]

    def _deferred_equality(self, op: str, lv: Value, rv: Value, e) -> CompiledExpr:
        lk = self.hash_keys(lv)
        rk = self.hash_keys(rv)
        if lk is None or rk is None:
            raise EngineException(
                "string comparison with a computed string requires both "
                "sides to be strings built from string columns/literals "
                "or stringified integers; CAST of double/timestamp values "
                f"to string cannot compare on device: {e!r}"
            )
        h1l, h2l, nl = lk
        h1r, h2r, nr = rk

        def run(env):
            eq = (h1l.fn(env) == h1r.fn(env)) & (h2l.fn(env) == h2r.fn(env))
            notnull = torch.logical_not(nl.fn(env)) & torch.logical_not(nr.fn(env))
            if op == "=":
                return eq & notnull
            return torch.logical_not(eq) & notnull

        return CompiledExpr("boolean", run, deps=h1l.deps + h1r.deps)

    def _comparison(self, op: str, l: CompiledExpr, r: CompiledExpr) -> CompiledExpr:
        lt, rt = l.type, r.type
        if ("string" in (lt, rt)) and lt != rt:
            raise EngineException(f"cannot compare {lt} with {rt}")
        if lt == "string" and op not in ("=", "!="):
            # lexicographic ordering via the dictionary rank table:
            # rank[id] is the string's position in sorted order, so
            # integer comparison of ranks IS string comparison. A NULL
            # operand (id 0) makes the comparison NULL -> false.
            self.aux.require_rank()
            import operator as _op

            f = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge}[op]

            def run_rank(env, l=l, r=r, f=f):
                t = env.scopes["__aux"][RANK_KEY]
                a, b = l.fn(env), r.fn(env)
                ra = _gather(t, a)
                rb = _gather(t, b)
                return f(ra, rb) & (a != 0) & (b != 0)

            return CompiledExpr("boolean", run_rank, deps=l.deps + r.deps)
        if lt == "string":
            # = / != with SQL null semantics: NULL compares as NULL ->
            # false either way (ids are exact string identity otherwise)
            def run_eq(env, l=l, r=r, eq=(op == "=")):
                a, b = l.fn(env), r.fn(env)
                nn = (a != 0) & (b != 0)
                return ((a == b) if eq else (a != b)) & nn

            return CompiledExpr("boolean", run_eq, deps=l.deps + r.deps)
        # timestamp/tssec comparisons: both sides share the batch base, so
        # relative values compare exactly
        cast = None
        if lt != rt and "string" not in (lt, rt):
            cast = _promote(lt, rt)

        import operator as _op

        fns = {
            "=": _op.eq, "!=": _op.ne, "<": _op.lt,
            "<=": _op.le, ">": _op.gt, ">=": _op.ge,
        }
        f = fns[op]

        def run(env, l=l, r=r, f=f, cast=cast):
            a, b = l.fn(env), r.fn(env)
            if cast is not None:
                a, b = _to_dtype(a, cast), _to_dtype(b, cast)
            return f(a, b)

        return CompiledExpr("boolean", run, deps=l.deps + r.deps)

    def _arith(self, op: str, l: CompiledExpr, r: CompiledExpr) -> CompiledExpr:
        lt, rt = l.type, r.type
        if "string" in (lt, rt):
            raise EngineException("arithmetic on strings is not supported")

        # time-typed special cases (see module docstring)
        if op == "*" and lt == "tssec" and rt == "long":
            # unix_timestamp()*1000 -> absolute epoch ms; keep it relative
            def run_ms(env, l=l, r=r):
                return l.fn(env).to(torch.int32) * 1000
            return CompiledExpr("timestamp", run_ms, deps=l.deps + r.deps)
        if op == "-" and lt in ("timestamp", "tssec") and rt == lt:
            out_t = "long"

            def run_diff(env, l=l, r=r):
                return l.fn(env).to(torch.int32) - r.fn(env).to(torch.int32)

            return CompiledExpr(out_t, run_diff, deps=l.deps + r.deps)
        if lt in ("timestamp", "tssec") and rt == "long" and op in ("+", "-"):
            def run_shift(env, l=l, r=r, neg=(op == "-")):
                b = r.fn(env).to(torch.int32)
                return l.fn(env) + (-b if neg else b)
            return CompiledExpr(lt, run_shift, deps=l.deps + r.deps)

        out_t = _promote(lt, rt)
        if op == "/":
            out_t = "double"

        import operator as _op

        # '%' is TRUNCATED modulo (sign follows the dividend) per
        # Spark/SQL semantics — torch.remainder/Python % are floored and flip
        # the sign for negative dividends
        fns = {"+": _op.add, "-": _op.sub, "*": _op.mul, "%": _trunc_mod}

        def run(env, l=l, r=r, op=op, out_t=out_t):
            a, b = _to_dtype(l.fn(env), out_t), _to_dtype(r.fn(env), out_t)
            if op == "/":
                return a / b
            return fns[op](a, b)

        return CompiledExpr(out_t, run, deps=l.deps + r.deps)

    def _unary(self, e: UnaryOp) -> Value:
        v = self._as_device(e.operand)
        if e.op == "NOT":
            return CompiledExpr(
                "boolean", lambda env, v=v: torch.logical_not(v.fn(env)), deps=v.deps
            )
        return CompiledExpr(v.type, lambda env, v=v: -v.fn(env), deps=v.deps)

    def _in_list(self, e: InList) -> Value:
        v = self._as_device(e.expr)
        opts = [self._as_device(o) for o in e.options]

        def run(env, v=v, opts=opts, neg=e.negated):
            a = v.fn(env)
            m = torch.zeros_like(a, dtype=torch.bool)
            for o in opts:
                m = m | (a == o.fn(env).to(a.dtype))
            return torch.logical_not(m) if neg else m

        deps = v.deps + tuple(d for o in opts for d in o.deps)
        return CompiledExpr("boolean", run, deps=deps)

    def _case(self, e: CaseWhen) -> Value:
        whens = [
            (self._as_device(c), self._as_device(x)) for c, x in e.whens
        ]
        otherwise = self._as_device(e.otherwise) if e.otherwise else None
        out_t = whens[0][1].type
        for _, x in whens[1:]:
            out_t = _promote(out_t, x.type)
        if otherwise is not None:
            out_t = _promote(out_t, otherwise.type)

        def run(env, whens=whens, otherwise=otherwise, out_t=out_t):
            if otherwise is not None:
                acc = _to_dtype(otherwise.fn(env), out_t)
            else:
                acc = torch.zeros(env.shape, dtype=_DTYPES[out_t], device=env.device)
            for cond, val in reversed(whens):
                acc = torch.where(cond.fn(env), _to_dtype(val.fn(env), out_t), acc)
            return acc

        deps = tuple(
            d for c, x in whens for d in c.deps + x.deps
        ) + (otherwise.deps if otherwise else ())
        return CompiledExpr(out_t, run, deps=deps)

    def _is_null(self, e: IsNull) -> Value:
        # strings carry a real null (dictionary id 0); for other types
        # row-validity is the null mechanism, so present values are
        # non-null
        v = self.compile(e.expr)
        if is_device(v) and v.type == "string":
            def run(env, v=v, neg=e.negated):
                ids = v.fn(env)
                return (ids != 0) if neg else (ids == 0)

            return CompiledExpr("boolean", run, deps=v.deps)
        val = bool(e.negated)
        return CompiledExpr(
            "boolean", lambda env, v=val: _full(env, v, torch.bool)
        )

    # -- dictionary-table string ops (compile/stringops.py) ---------------
    def _const_str(self, e: Expr, what: str) -> str:
        if isinstance(e, Literal) and e.kind == "str":
            return e.value
        raise EngineException(f"{what} must be a string literal, got {e!r}")

    def _const_int(self, e: Expr, what: str) -> int:
        if isinstance(e, Literal) and e.kind == "int":
            return e.value
        if isinstance(e, UnaryOp) and e.op == "-" \
                and isinstance(e.operand, Literal) and e.operand.kind == "int":
            return -e.operand.value
        raise EngineException(f"{what} must be an integer literal, got {e!r}")

    def _string_arg(self, e: Expr, fname: str) -> CompiledExpr:
        v = self.compile(e)
        if isinstance(v, HostStr):
            raise EngineException(
                f"{fname} over a deferred string (CONCAT/CAST result) is "
                "not supported on device — apply string functions to the "
                "columns before concatenating"
            )
        if not is_device(v) or v.type != "string":
            raise EngineException(f"{fname} expects a string argument, got {e!r}")
        return v

    def _aux_gather(
        self, key: str, kind: str, host_fn, arg: CompiledExpr, out_type: str
    ) -> CompiledExpr:
        """Register a dictionary table and compile to a device gather."""
        self.aux.register(key, kind, host_fn)

        def run(env, key=key, arg=arg):
            return _gather(env.scopes["__aux"][key], arg.fn(env))

        return CompiledExpr(out_type, run, deps=arg.deps)

    def _string_map(self, fname: str, e_arg: Expr, key: str, host_fn) -> Value:
        return self._aux_gather(
            f"map:{key}", "map", host_fn, self._string_arg(e_arg, fname), "string"
        )

    def _string_pred(self, fname: str, e_arg: Expr, key: str, host_fn) -> Value:
        return self._aux_gather(
            f"pred:{key}", "pred", host_fn, self._string_arg(e_arg, fname), "boolean"
        )

    def _string_scalar(self, fname: str, e_arg: Expr, key: str, host_fn) -> Value:
        return self._aux_gather(
            f"scalar:{key}", "scalar", host_fn, self._string_arg(e_arg, fname), "long"
        )

    def _like(self, e: LikeOp) -> Value:
        pattern = self._const_str(e.pattern, "LIKE/RLIKE pattern")
        if e.regex:
            rx = re.compile(pattern)
            key = f"RLIKE:{pattern}"
            fn = lambda s, rx=rx: rx.search(s) is not None  # noqa: E731
        else:
            rx = re.compile(like_to_regex(pattern), re.DOTALL)
            key = f"LIKE:{pattern}"
            fn = lambda s, rx=rx: rx.fullmatch(s) is not None  # noqa: E731
        pred = self._string_pred("LIKE", e.expr, key, fn)
        if not e.negated:
            return pred
        # NOT LIKE: null stays excluded (pred[null]=False either way is
        # SQL-correct for WHERE: NULL NOT LIKE p is NULL, not TRUE) — we
        # negate the table-level result but force null ids to False
        arg = self._string_arg(e.expr, "NOT LIKE")

        def run(env, pred=pred, arg=arg):
            ids = arg.fn(env)
            return torch.logical_not(pred.fn(env)) & (ids != 0)

        return CompiledExpr("boolean", run, deps=pred.deps)

    def _cast(self, e: Cast) -> Value:
        target = e.target
        if target in ("STRING", "VARCHAR"):
            inner = self._as_device(e.expr)
            if inner.type == "string":
                return inner
            # stringification is a host-side finishing step
            return HostStr(parts=["", inner], deps=inner.deps)
        inner = self._as_device(e.expr)
        t = {
            "LONG": "long", "INT": "long", "INTEGER": "long", "BIGINT": "long",
            "DOUBLE": "double", "FLOAT": "double", "BOOLEAN": "boolean",
            "TIMESTAMP": "timestamp",
        }.get(target)
        if t is None:
            raise EngineException(f"unsupported CAST target {target}")
        return CompiledExpr(
            t, lambda env, inner=inner, t=t: _to_dtype(inner.fn(env), t), deps=inner.deps
        )

    # -- functions -------------------------------------------------------
    def _func(self, e: Func) -> Value:
        name = e.name

        if name in AGGREGATE_FNS:
            raise EngineException(
                f"aggregate {name} outside aggregation context"
            )

        if name == "IF":
            if len(e.args) != 3:
                raise EngineException("IF takes 3 arguments")
            cond = self._as_device(e.args[0])
            then_v = self.compile(e.args[1])
            else_v = self.compile(e.args[2])
            # IF(cond, <struct/map>, NULL): nullable struct
            if isinstance(then_v, StructValue) and isinstance(e.args[2], Literal) \
                    and e.args[2].kind == "null":
                return StructValue(then_v.fields, validity=cond)
            if not is_device(then_v) or not is_device(else_v):
                raise EngineException("IF branches must be device values")
            out_t = _promote(then_v.type, else_v.type) if then_v.type != else_v.type \
                else then_v.type

            def run(env, cond=cond, a=then_v, b=else_v, out_t=out_t):
                return torch.where(
                    cond.fn(env), _to_dtype(a.fn(env), out_t), _to_dtype(b.fn(env), out_t)
                )

            return CompiledExpr(
                out_t, run, deps=cond.deps + then_v.deps + else_v.deps
            )

        if name == "COALESCE":
            args = [self._as_device(a) for a in e.args]
            return args[0]  # no value-level nulls on device

        if name in ("MAP",):
            # MAP('k1', v1, 'k2', v2, ...) with literal keys == struct
            if len(e.args) % 2 != 0:
                raise EngineException("MAP needs key/value pairs")
            fields: Dict[str, Value] = {}
            for i in range(0, len(e.args), 2):
                k = e.args[i]
                if not (isinstance(k, Literal) and k.kind == "str"):
                    raise EngineException("MAP keys must be string literals")
                fields[k.value] = self.compile(e.args[i + 1])
            return StructValue(fields)

        if name == "STRUCT":
            fields = {}
            for a in e.args:
                if isinstance(a, Col):
                    fields[a.parts[-1]] = self.compile(a)
                else:
                    raise EngineException(
                        "STRUCT arguments must be columns (use MAP for expressions)"
                    )
            return StructValue(fields)

        if name == "ARRAY":
            return ArrayValue([self.compile(a) for a in e.args])

        if name == "FILTERNULL":
            inner = self.compile(e.args[0])
            if not isinstance(inner, ArrayValue):
                raise EngineException("filterNull expects an Array")
            return inner

        if name == "CONCAT":
            parts: List[Union[str, CompiledExpr]] = []
            deps: Tuple[Tuple[str, str], ...] = ()
            for a in e.args:
                v = self.compile(a)
                if isinstance(v, HostStr):
                    if v.parts and isinstance(v.parts[0], str) \
                            and v.parts[0].startswith(WS_MARKER):
                        raise EngineException(
                            "CONCAT over a CONCAT_WS result is not supported"
                        )
                    parts.extend(v.parts)
                    deps += v.deps
                elif isinstance(v, CompiledExpr):
                    if isinstance(a, Literal) and a.kind == "str":
                        parts.append(a.value)
                    else:
                        parts.append(v)
                        deps += v.deps
                else:
                    raise EngineException("CONCAT of composite values unsupported")
            return HostStr(parts, deps)

        if name == "CURRENT_TIMESTAMP":
            return CompiledExpr(
                "timestamp",
                lambda env: env.now_rel_ms.expand(env.shape),
            )
        if name == "UNIX_TIMESTAMP":
            if e.args:
                ts = self._as_device(e.args[0])
                return CompiledExpr(
                    "tssec",
                    lambda env, ts=ts: ts.fn(env) // 1000,
                    deps=ts.deps,
                )
            return CompiledExpr(
                "tssec",
                lambda env: (env.now_rel_ms // 1000).expand(env.shape),
            )
        if name == "TO_UNIX_TIMESTAMP":
            ts = self._as_device(e.args[0])
            if ts.type not in ("timestamp", "tssec"):
                raise EngineException("to_unix_timestamp expects a timestamp")
            if ts.type == "tssec":
                return ts
            return CompiledExpr(
                "tssec", lambda env, ts=ts: ts.fn(env) // 1000, deps=ts.deps
            )
        if name in ("STRINGTOTIMESTAMP", "TO_TIMESTAMP"):
            # reference: BuiltInFunctionsHandler.scala:15-17 registers
            # stringToTimestamp (ConcurrentDateFormat) as the one
            # built-in UDF. Here: per-distinct-string parse on the host
            # via two aux tables (epoch seconds + millis fraction),
            # composed into batch-relative ms on device. Unparseable or
            # NULL strings yield relative 0 (the missing-timestamp
            # encode convention) rather than SQL NULL — int32 columns
            # carry no null slot.
            if len(e.args) != 1:
                raise EngineException(
                    f"{name} takes exactly one string argument (custom "
                    "format patterns are not supported; timestamps parse "
                    "as ISO-8601 or epoch seconds/millis)"
                )
            v = self._string_arg(e.args[0], name)
            from ..core.batch import parse_timestamp_ms

            int_min = -(2 ** 31)

            def sec_of(s: str):
                # aux tables are int32: any epoch-second value outside
                # the range (e.g. an 11-digit id parsed as a huge epoch,
                # or post-2038 dates) counts as unparseable — the table
                # write itself would otherwise OverflowError per batch
                ms = parse_timestamp_ms(s)
                if ms is None:
                    return int_min
                sec = int(ms // 1000)
                return sec if int_min < sec < 2 ** 31 else int_min

            def msfrac_of(s: str):
                ms = parse_timestamp_ms(s)
                return 0 if ms is None else int(ms % 1000)

            self.aux.register("ts.sec", "scalar", sec_of)
            self.aux.register("ts.msfrac", "scalar", msfrac_of)

            def run(env, arg=v, int_min=int_min):
                tsec = env.scopes["__aux"]["ts.sec"]
                tms = env.scopes["__aux"]["ts.msfrac"]
                ids = arg.fn(env)
                sec = _gather(tsec, ids)
                bad = (ids <= 0) | (sec == int_min)
                # saturate the batch-relative delta at ~±23 days before
                # the ms scaling (the ingest paths clip the same way) —
                # int32 would otherwise wrap and pass comparisons it
                # should fail
                delta_s = torch.clamp(sec - env.base_s, -2_000_000, 2_000_000)
                rel = delta_s * 1000 + _gather(tms, ids)
                return torch.where(bad, 0, rel).to(torch.int32)

            return CompiledExpr("timestamp", run, deps=v.deps)

        if name == "DATE_TRUNC":
            unit_lit = e.args[0]
            if not isinstance(unit_lit, Literal):
                raise EngineException("DATE_TRUNC unit must be a literal")
            unit = str(unit_lit.value).lower()
            ts = self._as_device(e.args[1])
            secs = {"second": 1, "minute": 60, "hour": 3600, "day": 86400}.get(unit)
            if secs is None:
                raise EngineException(f"unsupported DATE_TRUNC unit {unit}")
            abs_s = self._abs_seconds(ts)

            def run(env, abs_s=abs_s, secs=secs):
                total_s = abs_s(env)
                trunc_s = total_s - total_s % secs
                return ((trunc_s - env.base_s) * 1000).to(torch.int32)

            return CompiledExpr("timestamp", run, deps=ts.deps)
        if name in ("HOUR", "MINUTE", "SECOND"):
            ts = self._as_device(e.args[0])
            div = {"HOUR": 3600, "MINUTE": 60, "SECOND": 1}[name]
            mod = {"HOUR": 24, "MINUTE": 60, "SECOND": 60}[name]
            abs_s = self._abs_seconds(ts)

            def run(env, abs_s=abs_s, div=div, mod=mod):
                total_s = abs_s(env)
                return ((total_s // div) % mod).to(torch.int32)

            return CompiledExpr("long", run, deps=ts.deps)

        if name in ("GREATEST", "LEAST"):
            if len(e.args) < 2:
                raise EngineException(f"{name} needs at least two arguments")
            vals = [self._as_device(a) for a in e.args]
            for v in vals:
                if v.type not in ("long", "double", "timestamp", "tssec"):
                    raise EngineException(
                        f"{name} expects numeric arguments, got {v.type}"
                    )
            out_t = "double" if any(v.type == "double" for v in vals) else "long"
            jf = torch.maximum if name == "GREATEST" else torch.minimum
            dt = _DTYPES[out_t]

            def run(env, vals=vals, jf=jf, dt=dt):
                acc = vals[0].fn(env).to(dt)
                for v in vals[1:]:
                    acc = jf(acc, v.fn(env).to(dt))
                return acc

            return CompiledExpr(
                out_t, run,
                deps=tuple(d for v in vals for d in v.deps),
            )
        if name in ("POW", "POWER"):
            if len(e.args) != 2:
                raise EngineException(f"{name} takes exactly two arguments")
            base_v = self._as_device(e.args[0])
            exp_v = self._as_device(e.args[1])
            _promote(base_v.type, exp_v.type)  # rejects strings/booleans mix
            if "string" in (base_v.type, exp_v.type):
                raise EngineException("POW expects numeric arguments")
            return CompiledExpr(
                "double",
                lambda env, b=base_v, x=exp_v: torch.pow(
                    b.fn(env).to(torch.float32),
                    x.fn(env).to(torch.float32),
                ),
                deps=base_v.deps + exp_v.deps,
            )
        if name == "MOD":
            if len(e.args) != 2:
                raise EngineException("MOD takes exactly two arguments")
            # delegate to the '%' operator path: same promotion, same
            # string guard, same truncated-modulo semantics
            return self._arith(
                "%", self._as_device(e.args[0]), self._as_device(e.args[1])
            )
        if name == "SIGN":
            v = self._as_device(e.args[0])
            if v.type not in ("long", "double"):
                raise EngineException(
                    f"SIGN expects a numeric argument, got {v.type}"
                )
            return CompiledExpr(
                "double",
                lambda env, v=v: torch.sign(v.fn(env)).to(torch.float32),
                deps=v.deps,
            )
        if name in ("ABS", "FLOOR", "CEIL", "ROUND", "SQRT", "EXP", "LOG",
                    "LOG10", "LOG2", "CBRT"):
            v = self._as_device(e.args[0])
            jf = {
                "ABS": torch.abs, "FLOOR": torch.floor, "CEIL": torch.ceil,
                "ROUND": torch.round, "SQRT": torch.sqrt, "EXP": torch.exp,
                "LOG": torch.log, "LOG10": torch.log10, "LOG2": torch.log2,
                "CBRT": _cbrt,
            }[name]
            always_double = ("SQRT", "EXP", "LOG", "LOG10", "LOG2", "CBRT")
            out_t = "double" if name in always_double else v.type

            def run(env, v=v, jf=jf, out_t=out_t):
                x = v.fn(env)
                if jf is not torch.abs:
                    x = x.to(torch.float32)
                return _to_dtype(jf(x), out_t)

            return CompiledExpr(out_t, run, deps=v.deps)

        v = self._string_func(e)
        if v is not None:
            return v
        v = self._date_func(e)
        if v is not None:
            return v

        # UDF tiers
        lowered = name.lower()
        if lowered in self.udfs:
            obj = self.udfs[lowered]
            self.called_udfs.append(obj)
            return obj.compile_call(self, e)

        raise EngineException(f"unknown function {name}")

    # -- string function library (dictionary tables) ----------------------
    _SIMPLE_MAPS = {
        "UPPER": str.upper, "UCASE": str.upper,
        "LOWER": str.lower, "LCASE": str.lower,
        "TRIM": str.strip, "LTRIM": str.lstrip, "RTRIM": str.rstrip,
        "REVERSE": lambda s: s[::-1],
        "INITCAP": lambda s: " ".join(
            w[:1].upper() + w[1:].lower() for w in s.split(" ")
        ),
    }

    def _string_func(self, e: Func) -> Optional[Value]:
        """Spark string functions lowered to dictionary-table gathers.

        Semantics match Spark SQL (the engine behind the reference's
        ``spark.sql`` calls): 1-based positions, clamped SUBSTRING,
        NULL in -> NULL/false/0 out. Constant arguments are required
        wherever the table is keyed on them (patterns, positions).
        """
        name, args = e.name, e.args
        if name in self._SIMPLE_MAPS:
            return self._string_map(name, args[0], name, self._SIMPLE_MAPS[name])
        if name in ("LENGTH", "CHAR_LENGTH", "CHARACTER_LENGTH", "LEN"):
            return self._string_scalar("LENGTH", args[0], "LENGTH", len)
        if name in ("SUBSTRING", "SUBSTR"):
            pos = self._const_int(args[1], "SUBSTRING position")
            ln = (
                self._const_int(args[2], "SUBSTRING length")
                if len(args) > 2 else None
            )
            return self._string_map(
                name, args[0], f"SUBSTRING:{pos}:{ln}",
                lambda s, pos=pos, ln=ln: spark_substring(s, pos, ln),
            )
        if name == "REPLACE":
            search = self._const_str(args[1], "REPLACE search")
            repl = self._const_str(args[2], "REPLACE replacement") \
                if len(args) > 2 else ""
            return self._string_map(
                name, args[0], f"REPLACE:{search!r}:{repl!r}",
                lambda s, a=search, b=repl: s.replace(a, b),
            )
        if name == "TRANSLATE":
            frm = self._const_str(args[1], "TRANSLATE from")
            to = self._const_str(args[2], "TRANSLATE to")
            tbl = str.maketrans(frm[: len(to)], to[: len(frm)], frm[len(to):])
            return self._string_map(
                name, args[0], f"TRANSLATE:{frm!r}:{to!r}",
                lambda s, tbl=tbl: s.translate(tbl),
            )
        if name == "INSTR":
            sub = self._const_str(args[1], "INSTR substring")
            return self._string_scalar(
                name, args[0], f"INSTR:{sub!r}",
                lambda s, sub=sub: spark_instr(s, sub),
            )
        if name == "LOCATE":
            # LOCATE(substr, str[, pos]) — note the flipped arg order.
            # Spark returns 0 (not a 1-based hit) whenever pos < 1.
            sub = self._const_str(args[0], "LOCATE substring")
            start = self._const_int(args[2], "LOCATE pos") if len(args) > 2 else 1
            return self._string_scalar(
                name, args[1], f"LOCATE:{sub!r}:{start}",
                lambda s, sub=sub, p=start: (
                    0 if p < 1 else s.find(sub, p - 1) + 1
                ),
            )
        if name == "CONTAINS":
            sub = self._const_str(args[1], "CONTAINS substring")
            return self._string_pred(
                name, args[0], f"CONTAINS:{sub!r}", lambda s, sub=sub: sub in s
            )
        if name in ("STARTSWITH", "STARTS_WITH"):
            sub = self._const_str(args[1], "STARTSWITH prefix")
            return self._string_pred(
                name, args[0], f"STARTSWITH:{sub!r}",
                lambda s, sub=sub: s.startswith(sub),
            )
        if name in ("ENDSWITH", "ENDS_WITH"):
            sub = self._const_str(args[1], "ENDSWITH suffix")
            return self._string_pred(
                name, args[0], f"ENDSWITH:{sub!r}",
                lambda s, sub=sub: s.endswith(sub),
            )
        if name == "REGEXP_EXTRACT":
            pat = self._const_str(args[1], "REGEXP_EXTRACT pattern")
            idx = self._const_int(args[2], "REGEXP_EXTRACT group") \
                if len(args) > 2 else 1
            rx = re.compile(pat)

            def rex(s, rx=rx, idx=idx):
                m = rx.search(s)
                if m is None:
                    return ""  # Spark returns empty string on no match
                try:
                    return m.group(idx) or ""
                except (IndexError, re.error):
                    return ""

            return self._string_map(
                name, args[0], f"REGEXP_EXTRACT:{pat!r}:{idx}", rex
            )
        if name == "REGEXP_REPLACE":
            pat = self._const_str(args[1], "REGEXP_REPLACE pattern")
            repl = self._const_str(args[2], "REGEXP_REPLACE replacement")
            rx = re.compile(pat)
            # Spark uses Java's $N group refs; Python uses \g<N>. A Java
            # \$ escape means a literal dollar — protect it before the
            # group rewrite, and escape Python's own backslash refs.
            # Java binds the LONGEST digit run that is still a valid
            # group number ($10 with one group = group 1 + literal '0')
            # and errors when even the first digit names no group.
            def _java_repl_to_py(r: str, ngroups: int) -> str:
                out = []
                i = 0
                while i < len(r):
                    c = r[i]
                    if c == "\\":
                        if i + 1 >= len(r):
                            raise EngineException(
                                "REGEXP_REPLACE replacement ends with a "
                                "lone backslash (character to be escaped "
                                "is missing)"
                            )
                        nxt = r[i + 1]
                        # Java-escaped literal ($, \) — emit literally,
                        # re-escaping \ for Python's repl grammar
                        out.append("\\\\" if nxt == "\\" else nxt)
                        i += 2
                        continue
                    # Java's replacement grammar treats only ASCII 0-9
                    # as group digits (str.isdigit would admit Unicode
                    # digits and crash or mis-bind)
                    ascii_digit = lambda ch: "0" <= ch <= "9"
                    if c == "$":
                        if i + 1 >= len(r) or not ascii_digit(r[i + 1]):
                            raise EngineException(
                                "REGEXP_REPLACE replacement has an "
                                "illegal group reference: '$' must be "
                                "followed by a group number (escape a "
                                "literal dollar as \\$)"
                            )
                        j = i + 1
                        while (
                            j + 1 < len(r) and ascii_digit(r[j + 1])
                            and int(r[i + 1:j + 2]) <= ngroups
                        ):
                            j += 1
                        group = int(r[i + 1:j + 1])
                        if group > ngroups:
                            raise EngineException(
                                f"REGEXP_REPLACE replacement refers to "
                                f"group ${group} but the pattern has only "
                                f"{ngroups} group(s)"
                            )
                        out.append(f"\\g<{group}>")
                        i = j + 1
                        continue
                    out.append("\\\\" if c == "\\" else c)
                    i += 1
                return "".join(out)

            py_repl = _java_repl_to_py(repl, rx.groups)
            return self._string_map(
                name, args[0], f"REGEXP_REPLACE:{pat!r}:{repl!r}",
                lambda s, rx=rx, r=py_repl: rx.sub(r, s),
            )
        if name == "REPEAT":
            times = self._const_int(args[1], "REPEAT count")
            return self._string_map(
                name, args[0], f"REPEAT:{times}",
                lambda s, t=times: s * max(t, 0),
            )
        if name == "ASCII":
            # scalar tables are int32 and carry no NULL slot: NULL in ->
            # 0 out, the engine-wide scalar-table convention (LENGTH
            # shares it); Spark returns NULL here
            return self._string_scalar(
                "ASCII", args[0], "ASCII", lambda s: ord(s[0]) if s else 0
            )
        if name in ("LPAD", "RPAD"):
            ln = self._const_int(args[1], f"{name} length")
            pad = self._const_str(args[2], f"{name} pad") if len(args) > 2 else " "

            def dopad(s, ln=ln, pad=pad, left=(name == "LPAD")):
                if len(s) >= ln:
                    return s[:ln]
                fill = (pad * ln)[: ln - len(s)]
                return fill + s if left else s + fill

            return self._string_map(name, args[0], f"{name}:{ln}:{pad!r}", dopad)
        if name == "SPLIT_PART":
            delim = self._const_str(args[1], "SPLIT_PART delimiter")
            idx = self._const_int(args[2], "SPLIT_PART index")
            return self._string_map(
                name, args[0], f"SPLIT_PART:{delim!r}:{idx}",
                lambda s, d=delim, i=idx: spark_split_at(s, re.escape(d), i),
            )
        if name == "ELEMENT_AT" and args and isinstance(args[0], Func) \
                and args[0].name == "SPLIT":
            # element_at(split(s, regex), i): the composed function is one
            # dictionary table — SPLIT alone (an array) has no device form
            inner = args[0]
            delim = self._const_str(inner.args[1], "SPLIT delimiter")
            idx = self._const_int(args[1], "ELEMENT_AT index")
            return self._string_map(
                "SPLIT", inner.args[0], f"SPLIT_AT:{delim!r}:{idx}",
                lambda s, d=delim, i=idx: spark_split_at(s, d, i),
            )
        if name == "SPLIT":
            raise EngineException(
                "SPLIT returns an array; use ELEMENT_AT(SPLIT(s, d), i) or "
                "SPLIT_PART(s, d, i) to take one element"
            )
        if name == "CONCAT_WS":
            # Spark concat_ws SKIPS null arguments (and their
            # separators) instead of nulling the result like CONCAT, so
            # the deferred template keeps per-ARGUMENT structure: a
            # marker literal carries the separator and every following
            # part is one argument. The materializer joins the non-null
            # renders; nested computed-string arguments would lose their
            # grouping in this representation, so they are rejected.
            sep = self._const_str(args[0], "CONCAT_WS separator")
            parts: List[Union[str, CompiledExpr]] = [WS_MARKER + sep]
            deps: Tuple[Tuple[str, str], ...] = ()
            for a in args[1:]:
                v = self.compile(a)
                if isinstance(v, HostStr):
                    raise EngineException(
                        "CONCAT_WS over computed-string arguments is not "
                        "supported; CONCAT the pieces first or pass "
                        "plain columns/literals"
                    )
                if isinstance(v, CompiledExpr):
                    if isinstance(a, Literal) and a.kind == "str":
                        parts.append(a.value)
                    else:
                        parts.append(v)
                        deps += v.deps
                else:
                    raise EngineException("CONCAT_WS of composite values unsupported")
            return HostStr(parts, deps)
        return None

    # -- date/time function library ---------------------------------------
    def _abs_seconds(self, ts: CompiledExpr):
        """env -> absolute epoch seconds; honors the two time encodings
        (timestamp = relative ms, tssec = relative s)."""
        if ts.type == "tssec":
            return lambda env, ts=ts: env.base_s + ts.fn(env)
        if ts.type != "timestamp":
            raise EngineException(
                f"expected a timestamp-typed expression, got {ts.type}"
            )
        return lambda env, ts=ts: env.base_s + ts.fn(env) // 1000

    def _civil(self, ts: CompiledExpr):
        """(year, month, day) from a timestamp expr, UTC proleptic
        Gregorian (Howard Hinnant's civil_from_days, pure int32 math —
        no data-dependent control flow)."""
        abs_s = self._abs_seconds(ts)

        def parts(env, abs_s=abs_s):
            total_s = abs_s(env)
            days = total_s // 86400
            z = days + 719468
            era = z // 146097
            doe = z - era * 146097
            yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
            y = yoe + era * 400
            doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
            mp = (5 * doy + 2) // 153
            day = doy - (153 * mp + 2) // 5 + 1
            month = mp + torch.where(mp < 10, 3, -9).to(mp.dtype)
            year = y + (month <= 2).to(y.dtype)
            return year.to(torch.int32), month.to(torch.int32), day.to(torch.int32)

        return parts

    def _date_func(self, e: Func) -> Optional[Value]:
        name, args = e.name, e.args
        if name in ("YEAR", "MONTH", "DAY", "DAYOFMONTH"):
            ts = self._as_device(args[0])
            if ts.type not in ("timestamp", "tssec"):
                raise EngineException(f"{name} expects a timestamp")
            parts = self._civil(ts)
            pick = {"YEAR": 0, "MONTH": 1, "DAY": 2, "DAYOFMONTH": 2}[name]
            return CompiledExpr(
                "long", lambda env, parts=parts, pick=pick: parts(env)[pick],
                deps=ts.deps,
            )
        if name == "DAYOFWEEK":
            # Spark: 1 = Sunday .. 7 = Saturday; epoch day 0 is a Thursday
            ts = self._as_device(args[0])
            abs_s = self._abs_seconds(ts)

            def dow(env, abs_s=abs_s):
                days = abs_s(env) // 86400
                return ((days + 4) % 7 + 1).to(torch.int32)

            return CompiledExpr("long", dow, deps=ts.deps)
        if name == "DATEDIFF":
            a = self._as_device(args[0])
            b = self._as_device(args[1])
            abs_a, abs_b = self._abs_seconds(a), self._abs_seconds(b)

            def diff(env, abs_a=abs_a, abs_b=abs_b):
                da = abs_a(env) // 86400
                db = abs_b(env) // 86400
                return (da - db).to(torch.int32)

            return CompiledExpr("long", diff, deps=a.deps + b.deps)
        if name == "TO_DATE":
            ts = self._as_device(args[0])
            abs_s = self._abs_seconds(ts)

            def trunc_day(env, abs_s=abs_s):
                total_s = abs_s(env)
                t = total_s - total_s % 86400
                return ((t - env.base_s) * 1000).to(torch.int32)

            return CompiledExpr("timestamp", trunc_day, deps=ts.deps)
        if name == "FROM_UNIXTIME":
            # Spark returns a formatted string; here it stays a timestamp
            # (the host renders it at the sink boundary) — comparisons and
            # windowing on the result are exact either way
            v = self._as_device(args[0])
            if v.type == "tssec":  # already batch-relative seconds
                return CompiledExpr(
                    "timestamp",
                    lambda env, v=v: (v.fn(env) * 1000).to(torch.int32),
                    deps=v.deps,
                )

            def from_unix(env, v=v):  # absolute epoch seconds
                secs = v.fn(env).to(torch.int32)
                return ((secs - env.base_s) * 1000).to(torch.int32)

            return CompiledExpr("timestamp", from_unix, deps=v.deps)
        return None
