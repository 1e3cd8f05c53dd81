"""Select/pipeline planner: lower parsed SQL onto the ops layer.

The compiled artifact is a pure function over columnar tables — the
whole transform pipeline (all ``--DataXQuery--`` statements of a flow)
composes into one program of tensor operations the runtime runs every
micro-batch. This replaces the reference's per-batch ``spark.sql``
planning/execution (CommonProcessorFactory.scala:249-293).

Tables flow through as ``TableData`` (columns dict + validity mask);
capacities are static and derived per statement (input capacity for
project/filter/group-by, sum for unions). JOIN is not ported yet: it
waits for ``ops/join.py``.

Deferred string columns (CONCAT results etc.) materialize their device
inputs as hidden ``__defer.`` columns so they ride along through
downstream selects and become strings only on the host at sink time.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..core.config import EngineException
from ..core.schema import StringDictionary
from ..ops import compact_indices, distinct_mask, group_ids, segment_aggregate
from ..ops.groupby import INT32_MAX, INT32_MIN, lexsort
from .exprs import (
    AGGREGATE_FNS,
    ArrayValue,
    CompiledExpr,
    EvalEnv,
    ExprCompiler,
    HostStr,
    Scope,
    StructValue,
    Value,
    _full,
    _gather,
    is_device,
)
from .sqlparser import Col, Expr, Func, Select, SelectItem, Star

# ---------------------------------------------------------------------------
# Schemas and table data
# ---------------------------------------------------------------------------
DeferredPart = Union[str, Tuple[str, str]]  # literal | (hidden_col, type)


@dataclass(frozen=True)
class ViewSchema:
    """Device column types + deferred host-string column templates."""

    types: Dict[str, str]
    deferred: Dict[str, Tuple[DeferredPart, ...]] = field(default_factory=dict)

    def all_names(self) -> List[str]:
        """User-visible column names (device + deferred, no hidden)."""
        return [c for c in self.types if not c.startswith("__defer.")] + list(
            self.deferred
        )


@dataclass
class TableData:
    cols: Dict[str, torch.Tensor]
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    def count(self) -> torch.Tensor:
        """Valid rows as a 0-d int32 tensor (torch's sum would be int64)."""
        return self.valid.sum(dtype=torch.int32)


# ORDER BY two-tier resolution bindings (see _OrderKeyScope)
_OUT_BINDING = "__ob.out"
_SRC_BINDING_PREFIX = "__ob.src:"


class _OrderKeyScope(Scope):
    """Per-REFERENCE two-tier resolution for ORDER BY keys (Spark
    semantics): each column ref binds to an output alias first, then to
    a FROM-scope column. Resolving the whole expression against one
    scope or the other would rebind aliases that shadow source columns
    in mixed expressions like ``ORDER BY a + b`` with ``SELECT b AS a``.
    """

    def __init__(self, out_scope: Scope, src_scope: Scope):
        tables = {_OUT_BINDING: dict(out_scope.tables[""])}
        deferred = {}
        for b, cols in src_scope.tables.items():
            tables[_SRC_BINDING_PREFIX + b] = cols
        for b, d in src_scope.deferred.items():
            deferred[_SRC_BINDING_PREFIX + b] = d
        super().__init__(tables=tables, deferred=deferred)
        self._out = out_scope
        self._src = src_scope

    def resolve(self, parts):
        try:
            _, col = self._out.resolve(parts)
            return (_OUT_BINDING, col)
        except EngineException as out_err:
            try:
                b, col = self._src.resolve(parts)
            except EngineException:
                raise EngineException(
                    f"cannot resolve ORDER BY reference "
                    f"'{'.'.join(parts)}' against the select list or the "
                    f"FROM scope: {out_err}"
                ) from None
            return (_SRC_BINDING_PREFIX + b, col)


@dataclass
class CompiledView:
    name: str
    schema: ViewSchema
    capacity: int
    # fn(tables: {name: TableData}, base_s, now_rel_ms) -> TableData
    fn: Callable[[Dict[str, TableData], torch.Tensor, torch.Tensor], TableData]
    # select list in declaration order, for ORDER BY <ordinal> binding
    # (None for views not built from a select list, e.g. inputs)
    select_values: Optional[List[Tuple[str, Value]]] = None
    # ORDER BY keys naming deferred (computed-string) output columns
    # cannot sort on device; the runtime applies this ordering (+ limit)
    # on the materialized host rows instead — [(column, ascending)]
    host_order: Optional[List[Tuple[str, bool]]] = None
    host_limit: Optional[int] = None


# ---------------------------------------------------------------------------
# Aggregate-aware expression compiler
# ---------------------------------------------------------------------------
class _AggCollector(ExprCompiler):
    """ExprCompiler that records aggregate calls and compiles them into
    placeholder reads from the "__agg" scope."""

    def __init__(self, scope, dictionary, udfs, aux=None):
        super().__init__(scope, dictionary, udfs, aux=aux)
        self.agg_nodes: Dict[str, Tuple[str, Optional[Expr], bool]] = {}
        # custom aggregates (UDAF tier): key -> (udf, [arg exprs])
        self.udaf_nodes: Dict[str, Tuple[object, Tuple[Expr, ...]]] = {}
        self._counter = itertools.count()

    def _func(self, e: Func):
        if e.name in AGGREGATE_FNS:
            key = f"agg{next(self._counter)}"
            arg = None if (not e.args or isinstance(e.args[0], Star)) else e.args[0]
            self.agg_nodes[key] = (e.name, arg, e.distinct)
            out_t = self._agg_type(e.name, arg)
            return CompiledExpr(
                out_t, lambda env, key=key: env.scopes["__agg"][key]
            )
        udaf = self.udfs.get(e.name.lower())
        if udaf is not None and getattr(udaf, "is_aggregate", False):
            key = f"agg{next(self._counter)}"
            self.udaf_nodes[key] = (udaf, tuple(e.args))
            plain = ExprCompiler(self.scope, self.dictionary, self.udfs, aux=self.aux)
            arg_types = []
            for a in e.args:
                inner = plain.compile(a)
                if not is_device(inner):
                    raise EngineException(
                        f"cannot aggregate non-device expression {a!r}"
                    )
                arg_types.append(inner.type)
            out_t = udaf.result_type(arg_types)
            return CompiledExpr(
                out_t, lambda env, key=key: env.scopes["__agg"][key]
            )
        return super()._func(e)

    def _agg_type(self, name: str, arg: Optional[Expr]) -> str:
        if name == "COUNT":
            return "long"
        if arg is None:
            raise EngineException(f"{name} requires an argument")
        inner = ExprCompiler(self.scope, self.dictionary, self.udfs, aux=self.aux).compile(arg)
        if not is_device(inner):
            raise EngineException(f"cannot aggregate non-device expression {arg!r}")
        if name == "AVG":
            return "double"
        if name == "SUM":
            return "double" if inner.type == "double" else "long"
        return inner.type  # MIN/MAX preserve


def _has_aggregate(e: Expr) -> bool:
    if isinstance(e, Func):
        if e.name in AGGREGATE_FNS:
            return True
        return any(_has_aggregate(a) for a in e.args if not isinstance(a, Star))
    for attr in ("left", "right", "operand", "expr"):
        sub = getattr(e, attr, None)
        if sub is not None and not isinstance(sub, (str, tuple)) and _has_aggregate(sub):
            return True
    if hasattr(e, "whens"):
        for c, v in e.whens:
            if _has_aggregate(c) or _has_aggregate(v):
                return True
        if e.otherwise is not None and _has_aggregate(e.otherwise):
            return True
    if hasattr(e, "options"):
        return any(_has_aggregate(o) for o in e.options)
    return False


# ---------------------------------------------------------------------------
# Planner config
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlannerConfig:
    # grouped outputs are compacted to the front, so their capacity can be
    # bounded below the input capacity — this is what keeps downstream
    # shapes small when grouping huge windowed tables (groups beyond the
    # bound drop; the runtime surfaces overflow as a metric, and the
    # flow sets the bound via conf process.maxgroups)
    max_group_capacity: int = 4096


# ---------------------------------------------------------------------------
# Select compiler
# ---------------------------------------------------------------------------
class SelectCompiler:
    def __init__(
        self,
        catalog: Dict[str, ViewSchema],
        capacities: Dict[str, int],
        dictionary: StringDictionary,
        udfs: Optional[dict] = None,
        config: PlannerConfig = PlannerConfig(),
        aux: Optional["AuxRegistry"] = None,
    ):
        self.catalog = catalog
        self.capacities = capacities
        self.dictionary = dictionary
        self.udfs = udfs or {}
        self.config = config
        # shared dictionary-table registry (device string ops); the
        # runtime materializes these tables per batch and passes them in
        # under the "__aux" pseudo-table (compile/stringops.py)
        from .stringops import AuxRegistry

        self.aux = aux if aux is not None else AuxRegistry()

    def _expr_compiler(self, scope: Scope) -> ExprCompiler:
        return ExprCompiler(scope, self.dictionary, self.udfs, aux=self.aux)

    # -- entry -----------------------------------------------------------
    def compile_select(self, name: str, sel: Select) -> CompiledView:
        if sel.union is not None:
            return self._compile_union(name, sel)
        return self._compile_single(name, sel)

    @staticmethod
    def _inject_aux(scopes, tables) -> None:
        """Expose the dictionary string-op tables to expressions (the
        "__aux" pseudo-scope; see compile/stringops.py)."""
        scopes["__aux"] = tables.get("__aux", {})

    # -- union -----------------------------------------------------------
    def _compile_union(self, name: str, sel: Select) -> CompiledView:
        branches: List[Select] = []
        cur: Optional[Select] = sel
        while cur is not None:
            branches.append(replace(cur, union=None, union_distinct=False))
            cur = cur.union
        # a trailing ORDER BY/LIMIT parses into the last branch but (per
        # SQL) applies to the whole union — hoist it
        order_by, limit = branches[-1].order_by, branches[-1].limit
        branches[-1] = replace(branches[-1], order_by=(), limit=None)
        compiled = [self._compile_single(f"{name}${i}", b) for i, b in enumerate(branches)]
        first = compiled[0]
        names0 = list(first.schema.types) + list(first.schema.deferred)
        for c in compiled[1:]:
            if len(list(c.schema.types)) != len(list(first.schema.types)):
                raise EngineException(
                    f"UNION branches of {name} have different column counts"
                )
        capacity = sum(c.capacity for c in compiled)
        # align by position onto the first branch's names
        maps = []
        for c in compiled:
            maps.append(dict(zip(c.schema.types, first.schema.types)))

        def run(tables, base_s, now_rel_ms, compiled=compiled, maps=maps):
            outs = [c.fn(tables, base_s, now_rel_ms) for c in compiled]
            cols = {}
            for target in first.schema.types:
                parts = []
                for out, m in zip(outs, maps):
                    src = [k for k, v in m.items() if v == target]
                    parts.append(out.cols[src[0]])
                cols[target] = torch.cat(parts)
            valid = torch.cat([o.valid for o in outs])
            return TableData(cols, valid)

        schema = ViewSchema(dict(first.schema.types), dict(first.schema.deferred))
        view = CompiledView(
            name, schema, capacity, run,
            select_values=compiled[0].select_values,
        )
        if order_by or limit is not None:
            view = self._apply_order_limit(view, order_by, limit)
        return view

    # -- single select ---------------------------------------------------
    def _compile_single(self, name: str, sel: Select) -> CompiledView:
        if sel.from_table is None:
            raise EngineException(f"SELECT without FROM not supported ({name})")

        # 1. FROM scope
        scope, build_scope, scope_capacity = self._compile_from(sel)

        compiler = _AggCollector(scope, self.dictionary, self.udfs, aux=self.aux)

        # 2. WHERE
        where_fn = None
        if sel.where is not None:
            where_c = self._expr_compiler(scope).compile(sel.where)
            if not is_device(where_c):
                raise EngineException("WHERE must be device-computable")
            where_fn = where_c.fn

        grouped = bool(sel.group_by) or any(
            _has_aggregate(i.expr) for i in sel.items if not isinstance(i.expr, Star)
        ) or (sel.having is not None and _has_aggregate(sel.having))

        # 3. select items -> named output values
        out_values: List[Tuple[str, Value]] = []
        for item in sel.items:
            out_values.extend(self._expand_item(item, scope, compiler))

        out_types, deferred, flat_outputs = self._flatten_outputs(out_values)

        if grouped:
            # HAVING compiles with the SAME collector so its aggregates
            # (possibly absent from the select list) compute per group
            having_c = (
                compiler.compile(sel.having) if sel.having is not None else None
            )
            if having_c is not None and not is_device(having_c):
                raise EngineException("HAVING must be device-computable")
            view = self._compile_grouped(
                name, sel, scope, compiler, build_scope, scope_capacity,
                where_fn, out_types, deferred, flat_outputs, out_values,
                having_fn=having_c.fn if having_c is not None else None,
            )
            view.select_values = out_values
            if sel.order_by or sel.limit is not None:
                # grouped: output rows are groups, not source rows, so
                # keys resolve against the output scope only (as Spark
                # requires grouping/aggregate expressions here)
                view = self._apply_order_limit(view, sel.order_by, sel.limit)
            return view

        if sel.having is not None:
            raise EngineException(
                f"HAVING without aggregation in {name}; use WHERE"
            )
        if compiler.udaf_nodes:
            names = ", ".join(u.name for u, _ in compiler.udaf_nodes.values())
            raise EngineException(
                f"aggregate UDF ({names}) requires GROUP BY in {name}"
            )

        # 4. plain projection/filter
        distinct_keys = None
        if sel.distinct:
            distinct_keys = self._distinct_key_exprs(out_values)

        def run(tables, base_s, now_rel_ms):
            scopes, valid, shape = build_scope(tables, base_s, now_rel_ms)
            self._inject_aux(scopes, tables)
            env = EvalEnv(scopes, base_s, now_rel_ms, shape)
            if where_fn is not None:
                valid = valid & where_fn(env)
            cols = {n: fn(env) for n, fn in flat_outputs}
            if distinct_keys is not None:
                env2 = EvalEnv(scopes, base_s, now_rel_ms, shape)
                keys = [k.fn(env2) for k in distinct_keys]
                valid = distinct_mask(keys, valid)
            return TableData(cols, valid)

        schema = ViewSchema(out_types, deferred)
        view = CompiledView(
            name, schema, scope_capacity, run, select_values=out_values,
        )
        if sel.order_by or sel.limit is not None:
            # Spark rejects DISTINCT + ORDER BY on unselected columns
            # (the sort key would come from an arbitrary representative
            # row), so the source-scope fallback is withheld there
            view = self._apply_order_limit(
                view, sel.order_by, sel.limit,
                src_scope=None if sel.distinct else scope,
                src_build=None if sel.distinct else build_scope,
            )
        return view

    # -- FROM / JOIN -----------------------------------------------------
    def _view(self, table: str) -> ViewSchema:
        if table not in self.catalog:
            raise EngineException(f"unknown table '{table}'")
        return self.catalog[table]

    def _compile_from(self, sel: Select):
        """Returns (scope, build_scope_fn, capacity).

        build_scope_fn(tables, base_s, now) -> (scopes dict, valid, shape)
        """
        if sel.joins:
            raise EngineException(
                "JOIN is not ported yet: it waits for ops/join.py"
            )
        base = sel.from_table
        base_schema = self._view(base.name)
        scope = Scope(
            tables={base.binding: dict(base_schema.types)},
            deferred={base.binding: self._deferred_exprs(base.binding, base_schema)},
        )

        def build(tables, base_s, now_rel_ms, b=base):
            t = tables[b.name]
            return {b.binding: t.cols}, t.valid, t.valid.shape

        return scope, build, self.capacities[base.name]

    # -- select item expansion -------------------------------------------
    def _deferred_exprs(
        self, binding: str, schema: ViewSchema
    ) -> Dict[str, HostStr]:
        out = {}
        for col, parts in schema.deferred.items():
            new_parts: List[Union[str, CompiledExpr]] = []
            deps: Tuple[Tuple[str, str], ...] = ()
            for p in parts:
                if isinstance(p, str):
                    new_parts.append(p)
                else:
                    hidden, t = p
                    new_parts.append(
                        CompiledExpr(
                            t,
                            lambda env, b=binding, c=hidden: env.column(b, c),
                            deps=((binding, hidden),),
                        )
                    )
                    deps += ((binding, hidden),)
            out[col] = HostStr(new_parts, deps)
        return out

    def _expand_item(
        self, item: SelectItem, scope: Scope, compiler: ExprCompiler
    ) -> List[Tuple[str, Value]]:
        if isinstance(item.expr, Star):
            out = []
            bindings = (
                [item.expr.table] if item.expr.table else
                [b for b in scope.tables if b != "" or len(scope.tables) == 1]
            )
            # for join scopes prefer the merged "" binding to avoid dupes
            if "" in scope.tables and item.expr.table is None:
                bindings = [""]
            for b in bindings:
                for c, t in scope.tables[b].items():
                    if c.startswith("__defer."):
                        continue
                    out.append(
                        (
                            c,
                            CompiledExpr(
                                t,
                                lambda env, b=b, c=c: env.column(b, c),
                                deps=((b, c),),
                            ),
                        )
                    )
                for c, h in scope.deferred.get(b, {}).items():
                    out.append((c, h))
            return out

        value = compiler.compile(item.expr)
        name = item.alias
        if name is None:
            if isinstance(item.expr, Col):
                name = item.expr.parts[-1]
            else:
                raise EngineException(
                    f"select expression requires an alias: {item.expr!r}"
                )
        return [(name, value)]

    def _flatten_outputs(self, out_values: List[Tuple[str, Value]]):
        """Flatten named Values into device columns + deferred templates.

        Returns (types, deferred, flat: [(col_name, fn)]).
        """
        types: Dict[str, str] = {}
        deferred: Dict[str, Tuple[DeferredPart, ...]] = {}
        flat: List[Tuple[str, Callable]] = []

        def add_device(col: str, ce: CompiledExpr):
            if col in types:
                raise EngineException(f"duplicate output column {col}")
            types[col] = ce.type
            flat.append((col, ce.fn))

        def walk(prefix: str, v: Value):
            if isinstance(v, CompiledExpr):
                add_device(prefix, v)
            elif isinstance(v, StructValue):
                if v.validity is not None:
                    add_device(prefix + ".__valid", v.validity)
                for f, sub in v.fields.items():
                    walk(prefix + "." + f, sub)
            elif isinstance(v, ArrayValue):
                for i, el in enumerate(v.elements):
                    if isinstance(el, StructValue) and el.validity is None:
                        el = StructValue(el.fields, validity=CompiledExpr(
                            "boolean",
                            lambda env: _full(env, True, torch.bool),
                        ))
                    walk(f"{prefix}.{i}", el)
            elif isinstance(v, HostStr):
                parts: List[DeferredPart] = []
                for i, p in enumerate(v.parts):
                    if isinstance(p, str):
                        parts.append(p)
                    else:
                        hidden = f"__defer.{prefix}.{i}"
                        add_device(hidden, p)
                        parts.append((hidden, p.type))
                deferred[prefix] = tuple(parts)
            else:
                raise EngineException(f"cannot output value {v!r}")

        for name, v in out_values:
            walk(name, v)
        return types, deferred, flat

    def _distinct_key_exprs(self, out_values) -> List[CompiledExpr]:
        keys: List[CompiledExpr] = []
        for _, v in out_values:
            keys.extend(self._device_keys_of(v))
        return keys

    def _device_keys_of(self, v: Value) -> List[CompiledExpr]:
        if isinstance(v, CompiledExpr):
            return [v]
        if isinstance(v, StructValue):
            out = []
            if v.validity is not None:
                out.append(v.validity)
            for sub in v.fields.values():
                out.extend(self._device_keys_of(sub))
            return out
        if isinstance(v, ArrayValue):
            out = []
            for el in v.elements:
                out.extend(self._device_keys_of(el))
            return out
        if isinstance(v, HostStr):
            return [p for p in v.parts if isinstance(p, CompiledExpr)]
        return []

    # -- ORDER BY / LIMIT ------------------------------------------------
    @staticmethod
    def _col_refs(expr) -> List[str]:
        """Dotted names of every column reference inside an expression."""
        refs: List[str] = []

        def walk(node):
            if isinstance(node, Col):
                refs.append(".".join(node.parts))
                return
            if hasattr(node, "__dataclass_fields__"):
                for f in node.__dataclass_fields__:
                    walk(getattr(node, f))
            elif isinstance(node, (tuple, list)):
                for el in node:
                    walk(el)

        walk(expr)
        return refs

    def _apply_order_limit(
        self, view: CompiledView, order_by, limit,
        *, src_scope=None, src_build=None,
    ) -> CompiledView:
        """Wrap a view with device-side ordering and/or row limiting.

        ORDER BY sorts valid rows to the front with a stable lexsort
        (invalid rows last); string keys sort by dictionary rank, i.e.
        true lexicographic order. LIMIT keeps the first N rows — with an
        ORDER BY the output capacity shrinks to N, so downstream shapes
        (and transfers) get smaller, the fixed-shape analog of Spark's
        TakeOrdered.

        Keys resolve against the view's OUTPUT columns (select aliases)
        first, then — Spark semantics — against the FROM-scope columns
        when the caller supplies one (``src_scope``/``src_build``; only
        sound for ungrouped selects, where output row i is scope row i).
        ``view.select_values`` (the select list in declaration order)
        binds ``ORDER BY <ordinal>`` including deferred-string items.
        """
        from .stringops import RANK_KEY

        visible = [
            c for c in view.schema.types
            if not c.startswith("__defer.") and not c.endswith(".__valid")
        ]
        out_scope = Scope(tables={"": {
            c: view.schema.types[c] for c in visible
        }})
        if src_scope is not None:
            key_scope: Scope = _OrderKeyScope(out_scope, src_scope)
        else:
            key_scope = out_scope
        compiler = self._expr_compiler(key_scope)
        select_values = view.select_values
        # keys: (CompiledExpr, ascending)
        keys: List[Tuple[CompiledExpr, bool]] = []
        from .sqlparser import Literal as _Lit

        # host-order path: a key NAMING a deferred (computed-string)
        # output column has no device representation to sort by. When
        # every key is a plain output-column reference (or ordinal),
        # the whole ordering + limit moves to the host, applied to the
        # materialized rows — Spark-composable ORDER BY on CONCAT/CAST
        # results, at host cost for only the rows that cross the
        # boundary. Keys that EMBED a deferred column in a larger
        # expression still fail below.
        def _plain_name(expr) -> Optional[str]:
            if (
                isinstance(expr, _Lit) and expr.kind == "int"
                and select_values and 1 <= expr.value <= len(select_values)
            ):
                return select_values[expr.value - 1][0]
            if isinstance(expr, Col) and len(expr.parts) == 1:
                return expr.parts[0]
            return None

        plain_names = [_plain_name(i.expr) for i in order_by]
        if any(n in view.schema.deferred for n in plain_names if n):
            if all(
                n and (n in view.schema.deferred or n in view.schema.types)
                for n in plain_names
            ):
                return replace(
                    view,
                    host_order=[
                        (n, i.ascending)
                        for n, i in zip(plain_names, order_by)
                    ],
                    host_limit=limit,
                )
            raise EngineException(
                "ORDER BY mixing a computed-string column with "
                "non-column expressions is not supported; order by the "
                "output columns directly"
            )

        for item in order_by:
            expr = item.expr
            if isinstance(expr, _Lit) and expr.kind == "int":
                # ORDER BY <ordinal>: 1-based select-list position,
                # counted over the FULL select list (deferred strings
                # and structs included), not just device columns
                if select_values is not None:
                    if not (1 <= expr.value <= len(select_values)):
                        raise EngineException(
                            f"ORDER BY position {expr.value} is out of range "
                            f"(select list has {len(select_values)} items)"
                        )
                    sel_name, sel_val = select_values[expr.value - 1]
                    if isinstance(sel_val, HostStr):
                        raise EngineException(
                            f"ORDER BY position {expr.value} refers to a "
                            f"deferred string expression ('{sel_name}'); "
                            "computed strings cannot be ordering keys"
                        )
                    if isinstance(sel_val, (StructValue, ArrayValue)):
                        raise EngineException(
                            f"ORDER BY position {expr.value} refers to "
                            f"composite column '{sel_name}'; order by a "
                            "scalar field instead"
                        )
                    expr = Col((sel_name,))
                else:
                    if not (1 <= expr.value <= len(visible)):
                        raise EngineException(
                            f"ORDER BY position {expr.value} is out of range "
                            f"(select list has {len(visible)} device columns)"
                        )
                    expr = Col((visible[expr.value - 1],))
            # any column ref naming a deferred-string output item must
            # error (not silently fall through to a same-named source
            # column the alias shadows) — also inside larger expressions
            shadowed = [
                r for r in self._col_refs(expr)
                if r in view.schema.deferred
            ]
            if shadowed:
                raise EngineException(
                    f"ORDER BY key references deferred string "
                    f"expression(s) {shadowed}; computed strings cannot "
                    "be ordering keys"
                )
            ce = compiler.compile(expr)
            if not is_device(ce):
                raise EngineException(
                    "ORDER BY key must be a device column/expression "
                    f"(deferred strings cannot order): {item.expr!r}"
                )
            if ce.type == "string":
                self.aux.require_rank()
            keys.append((ce, item.ascending))

        # does any key read a FROM-scope column the output lacks?
        need_src = any(
            b.startswith(_SRC_BINDING_PREFIX)
            for ce, _ in keys for b, _c in ce.deps
        )

        def run(tables, base_s, now_rel_ms):
            t = view.fn(tables, base_s, now_rel_ms)
            valid = t.valid
            cols = t.cols
            if keys:
                # output columns are visible under both the plain ""
                # binding and the _OUT binding the two-tier scope emits
                scopes = {"": cols, _OUT_BINDING: cols}
                if need_src:
                    # re-derive the FROM scope (the projection's columns
                    # are plain tensor reads)
                    scopes_s, _, _shape_s = src_build(tables, base_s, now_rel_ms)
                    for b, sc_cols in scopes_s.items():
                        scopes[_SRC_BINDING_PREFIX + b] = sc_cols
                self._inject_aux(scopes, tables)
                env = EvalEnv(scopes, base_s, now_rel_ms, valid.shape)
                sort_keys = []
                for ce, asc in keys:
                    arr = ce.fn(env)
                    if ce.type == "string":
                        arr = _gather(scopes["__aux"][RANK_KEY], arr)
                    if arr.dtype == torch.bool:
                        arr = arr.to(torch.int32)
                    if not asc:
                        arr = -arr
                    sort_keys.append(arr)
                # lexsort: LAST key is primary -> invalid rows sort last,
                # then keys in reverse significance order (stable)
                perm = lexsort(
                    tuple(reversed(sort_keys))
                    + (torch.logical_not(valid).to(torch.int32),)
                )
                cols = {
                    c: (a[perm] if a.shape[:1] == valid.shape else a)
                    for c, a in cols.items()
                }
                valid = valid[perm]
            if limit is not None:
                if keys:
                    # rows are sorted valid-first: a plain prefix mask
                    keep = torch.arange(valid.shape[0], device=valid.device) < limit
                else:
                    # unsorted: keep the first N valid rows in place
                    keep = torch.cumsum(valid.to(torch.int32), 0) <= limit
                valid = valid & keep
                if keys and limit < valid.shape[0]:
                    cols = {
                        c: (a[:limit] if a.shape[:1] == (valid.shape[0],) else a)
                        for c, a in cols.items()
                    }
                    valid = valid[:limit]
            return TableData(cols, valid)

        capacity = view.capacity
        if limit is not None and keys and limit < capacity:
            capacity = limit
        return CompiledView(
            view.name, view.schema, capacity, run,
            select_values=view.select_values,
        )

    # -- grouped path ----------------------------------------------------
    def _compile_grouped(
        self, name, sel, scope, compiler, build_scope, scope_capacity,
        where_fn, out_types, deferred, flat_outputs, out_values,
        having_fn=None,
    ) -> CompiledView:
        # group keys: resolve against select aliases first, then scope
        alias_map = {}
        for item in sel.items:
            if item.alias is not None:
                alias_map[item.alias.lower()] = item.expr
        key_exprs: List[Expr] = []
        for g in sel.group_by:
            if isinstance(g, Col) and len(g.parts) == 1 and g.parts[0].lower() in alias_map:
                key_exprs.append(alias_map[g.parts[0].lower()])
            else:
                key_exprs.append(g)

        key_compiled: List[CompiledExpr] = []
        plain = self._expr_compiler(scope)
        for g in key_exprs:
            v = plain.compile(g)
            if isinstance(v, HostStr):
                # computed string key: group by its device hash triple
                # (exact string-equality classes; stringified integers
                # hash their decimal rendering on device); when the
                # deferred expression embeds parts with no device tier
                # (CAST of doubles), fall back to grouping by the part
                # tuple — a refinement of string equality (may split
                # "a"+"bc" from "ab"+"c")
                hk = plain.hash_keys(v)
                if hk is not None:
                    key_compiled.extend(hk)
                else:
                    key_compiled.extend(
                        p for p in v.parts if isinstance(p, CompiledExpr)
                    )
            elif is_device(v):
                key_compiled.append(v)
            else:
                raise EngineException(f"cannot group by composite value {g!r}")

        agg_nodes = compiler.agg_nodes  # populated during _expand_item
        agg_args: Dict[str, Optional[CompiledExpr]] = {}
        for key, (fname, arg, dist) in agg_nodes.items():
            agg_args[key] = (
                None if arg is None else plain.compile_device(arg, f"{fname} argument")
            )
            if (
                fname in ("MIN", "MAX")
                and agg_args[key] is not None
                and agg_args[key].type == "string"
            ):
                # string MIN/MAX aggregate in rank space (lexicographic),
                # mapped back to ids via the inverse table
                self.aux.require_rank()
        udaf_nodes = compiler.udaf_nodes
        udaf_args: Dict[str, List[CompiledExpr]] = {
            key: [
                plain.compile_device(a, f"{udf.name} argument")
                for a in args
            ]
            for key, (udf, args) in udaf_nodes.items()
        }

        capacity = min(scope_capacity, self.config.max_group_capacity)

        def run(tables, base_s, now_rel_ms):
            scopes, valid, shape = build_scope(tables, base_s, now_rel_ms)
            self._inject_aux(scopes, tables)
            aux_tables = scopes["__aux"]
            env = EvalEnv(scopes, base_s, now_rel_ms, shape)
            if where_fn is not None:
                valid = valid & where_fn(env)

            keys = [k.fn(env) for k in key_compiled]
            order, seg, num_groups, first = group_ids(keys, valid)
            valid_s = valid[order]

            # aggregate values
            agg_results: Dict[str, torch.Tensor] = {}
            for key, (fname, arg, dist) in agg_nodes.items():
                if fname == "COUNT" and agg_args[key] is None:
                    agg_results[key] = segment_aggregate(
                        None, seg, capacity, "count", valid_s
                    )
                    continue
                vals = agg_args[key].fn(env)[order]
                if fname == "COUNT" and dist:
                    agg_results[key] = _distinct_count(
                        agg_args[key].fn(env), order, seg, valid_s, capacity
                    )
                elif fname == "COUNT":
                    agg_results[key] = segment_aggregate(
                        None, seg, capacity, "count", valid_s
                    )
                elif fname == "SUM":
                    z = torch.where(valid_s, vals, torch.zeros_like(vals))
                    agg_results[key] = segment_aggregate(
                        z, seg, capacity, "sum", valid_s
                    )
                elif fname == "AVG":
                    zf = torch.where(valid_s, vals, torch.zeros_like(vals)).to(
                        torch.float32
                    )
                    s = segment_aggregate(zf, seg, capacity, "sum", valid_s)
                    c = segment_aggregate(None, seg, capacity, "count", valid_s)
                    agg_results[key] = s / torch.clamp(c, min=1).to(torch.float32)
                elif fname in ("MIN", "MAX"):
                    op = fname.lower()
                    is_string = agg_args[key].type == "string"
                    live = valid_s
                    if is_string:
                        # lexicographic min/max: aggregate ranks, invert.
                        # SQL MIN/MAX ignore NULLs, so null ids (0) are
                        # masked out like invalid rows
                        from .stringops import RANK_KEY, UNRANK_KEY

                        live = live & (vals != 0)
                        vals = _gather(aux_tables[RANK_KEY], vals)
                    ident = (
                        INT32_MAX if vals.dtype == torch.int32
                        else float("inf")
                    )
                    if fname == "MAX":
                        ident = (
                            INT32_MIN if vals.dtype == torch.int32
                            else float("-inf")
                        )
                    z = torch.where(live, vals, torch.full_like(vals, ident))
                    res = segment_aggregate(z, seg, capacity, op, live)
                    if is_string:
                        # group with no non-null value -> NULL (rank 0 is
                        # always the null entry, so unrank[0] == id 0)
                        res = torch.where(res == ident, 0, res)
                        res = _gather(aux_tables[UNRANK_KEY], res)
                    agg_results[key] = res
            for key, (udf, _args) in udaf_nodes.items():
                arg_arrays = [a.fn(env)[order] for a in udaf_args[key]]
                agg_results[key] = udf.reduce(arg_arrays, seg, capacity, valid_s)

            # representative row per group (first sorted row)
            rep_sorted_idx, rep_valid = compact_indices(first, capacity)
            rep_idx = order[rep_sorted_idx]

            rep_scopes = {
                b: {c: arr[rep_idx] for c, arr in cols.items()}
                for b, cols in scopes.items()
                # dictionary tables are not row-shaped
                if b != "__aux"
            }
            rep_scopes["__agg"] = agg_results
            rep_scopes["__aux"] = aux_tables
            group_env = EvalEnv(rep_scopes, base_s, now_rel_ms, (capacity,))

            cols = {n: fn(group_env) for n, fn in flat_outputs}
            out_valid = torch.arange(capacity, device=valid.device) < num_groups
            if having_fn is not None:
                out_valid = out_valid & having_fn(group_env)
            # groups beyond the static capacity are dropped; ride the
            # drop count along as a hidden column so the runtime can
            # emit it as an overflow metric (Output_<n>_GroupsDropped)
            dropped = torch.clamp(num_groups - capacity, min=0).to(torch.int32)
            cols["__overflow.groups"] = dropped.expand(capacity)
            return TableData(cols, out_valid)

        schema = ViewSchema(out_types, deferred)
        return CompiledView(name, schema, capacity, run)


def _distinct_count(vals, order, seg, valid_s, capacity):
    """COUNT(DISTINCT x) per group: sort (seg, x) pairs, count pair-firsts."""
    x_s = vals[order]
    pair_order = lexsort([x_s.to(torch.int32), seg])
    seg_p = seg[pair_order]
    x_p = x_s[pair_order]
    valid_p = valid_s[pair_order]
    new_pair = torch.cat(
        [
            torch.ones((1,), dtype=torch.bool, device=seg.device),
            (seg_p[1:] != seg_p[:-1]) | (x_p[1:] != x_p[:-1]),
        ]
    )
    flags = (new_pair & valid_p).to(torch.int32)
    out = segment_aggregate(flags, seg_p, capacity, "sum", valid_p)
    return out
