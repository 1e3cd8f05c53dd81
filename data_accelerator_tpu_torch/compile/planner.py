"""Select/pipeline planner: lower parsed SQL onto the ops layer.

The compiled artifact is a pure function over columnar tables — the
whole transform pipeline (all ``--DataXQuery--`` statements of a flow)
composes into one program of tensor operations the runtime runs every
micro-batch. This replaces the reference's per-batch ``spark.sql``
planning/execution (CommonProcessorFactory.scala:249-293).

Tables flow through as ``TableData`` (columns dict + validity mask);
capacities are static and derived per statement (input capacity for
project/filter/group-by, configured bound for joins, sum for unions).
Each view records a ``StagePlan``, its lowering decisions (kind, row
counts, one ``JoinSite`` per JOIN, group bound, ORDER/LIMIT), as the JAX
package's planner does: the input of the cost model
(``analysis/costmodel.py``, ``analysis/deviceplan.py``). The JAX
package's ``sources`` and ``unshardable_udfs`` fields feed its mesh
planner and come with it (multi-GPU slice 8).

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
from ..ops.join import inner_join_indices, left_join_indices, sort_join_indices
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
from .sqlparser import BinOp, Col, Expr, Func, Select, SelectItem, Star

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


# ---------------------------------------------------------------------------
# Join sites: what the planner DECIDED for each JOIN, recorded at lowering
# time for static cost analysis. Shapes are static, so every capacity and
# algorithm choice below is exact.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class JoinSite:
    """One JOIN in a statement's FROM chain, as actually lowered."""

    kind: str  # "INNER" | "LEFT"
    right_table: str
    left_rows: int  # static rows feeding the left side of this site
    right_rows: int
    out_rows: int  # shared statement join capacity
    algorithm: str  # "sort-merge" | "match-matrix"
    n_eq_keys: int  # compiled equality key pairs
    has_residual: bool  # non-equi ON terms force the match matrix


@dataclass(frozen=True)
class StagePlan:
    """Static execution shape of one compiled view."""

    kind: str  # "project" | "group" | "union"
    input_rows: int  # FROM-scope capacity feeding the select
    output_rows: int  # final output capacity (post ORDER/LIMIT)
    joins: Tuple[JoinSite, ...] = ()
    grouped: bool = False
    group_keys: int = 0
    # column names the group keys read (for cardinality lints)
    group_key_cols: Tuple[str, ...] = ()
    n_aggregates: int = 0
    groups_bound: int = 0  # static group capacity (0 when ungrouped)
    distinct: bool = False
    order_keys: int = 0
    limit: Optional[int] = None
    union_branches: int = 1


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
    # lowering decisions, for static cost analysis (None for views built
    # outside the select compiler, e.g. raw inputs)
    plan: Optional[StagePlan] = None

    @property
    def joins(self) -> Tuple[JoinSite, ...]:
        """The JOINs this view lowered, in FROM order (a union's: every
        branch's)."""
        return self.plan.joins if self.plan is not None else ()


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
    # flow-configured absolute join output bound (conf
    # process.joincapacity); by default the largest side, at least 64
    join_capacity: Optional[int] = None
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
            plan=StagePlan(
                kind="union",
                input_rows=sum(
                    c.plan.input_rows if c.plan else c.capacity
                    for c in compiled
                ),
                output_rows=capacity,
                joins=tuple(s for c in compiled for s in c.joins),
                union_branches=len(compiled),
            ),
        )
        if order_by or limit is not None:
            view = self._apply_order_limit(view, order_by, limit)
        return view

    # -- single select ---------------------------------------------------
    def _compile_single(self, name: str, sel: Select) -> CompiledView:
        if sel.from_table is None:
            raise EngineException(f"SELECT without FROM not supported ({name})")

        # 1. FROM/JOIN scope
        scope, build_scope, scope_capacity, join_sites = self._compile_from(sel)

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
                join_sites=join_sites,
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
            meta = scopes.get("__meta")
            if meta is not None and "join_dropped" in meta:
                # rows lost to the join capacity bound ride along as a
                # hidden column -> Output_<n>_JoinRowsDropped metric
                cols["__overflow.joins"] = meta["join_dropped"].expand(shape)
            return TableData(cols, valid)

        schema = ViewSchema(out_types, deferred)
        view = CompiledView(
            name, schema, scope_capacity, run, select_values=out_values,
            plan=StagePlan(
                kind="project",
                input_rows=scope_capacity,
                output_rows=scope_capacity,
                joins=tuple(join_sites),
                distinct=bool(sel.distinct),
            ),
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
        """Returns (scope, build_scope_fn, capacity, join_sites).

        build_scope_fn(tables, base_s, now) -> (scopes dict, valid, shape)
        """
        base = sel.from_table
        base_schema = self._view(base.name)
        base_cap = self.capacities[base.name]

        if not sel.joins:
            scope = Scope(
                tables={base.binding: dict(base_schema.types)},
                deferred={base.binding: self._deferred_exprs(base.binding, base_schema)},
            )

            def build(tables, base_s, now_rel_ms, b=base):
                t = tables[b.name]
                return {b.binding: t.cols}, t.valid, t.valid.shape

            return scope, build, base_cap, []

        # join chain: fold joins left-to-right into one merged table
        bindings = [(base.binding, base.name, base_schema)]
        for j in sel.joins:
            bindings.append((j.table.binding, j.table.name, self._view(j.table.name)))
        if len({b for b, _, _ in bindings}) != len(bindings):
            raise EngineException("duplicate table bindings in join")

        # merged column names: bare when unique, else qualified
        all_cols: Dict[str, int] = {}
        for _, _, sch in bindings:
            for c in sch.types:
                all_cols[c] = all_cols.get(c, 0) + 1
            for c in sch.deferred:
                all_cols[c] = all_cols.get(c, 0) + 1

        def merged_name(binding: str, col: str) -> str:
            return col if all_cols[col] == 1 else f"{binding}.{col}"

        merged_types: Dict[str, str] = {}
        merged_deferred: Dict[str, Tuple[DeferredPart, ...]] = {}
        for b, _, sch in bindings:
            for c, t in sch.types.items():
                merged_types[merged_name(b, c)] = t
            for c, parts in sch.deferred.items():
                merged_deferred[merged_name(b, c)] = tuple(
                    p if isinstance(p, str) else (merged_name(b, p[0]), p[1])
                    for p in parts
                )

        merged_schema = ViewSchema(merged_types, merged_deferred)
        out_cap = self._join_capacity(sel)

        # compile each join's ON condition against the two-sided scope
        join_plans = []
        left_bindings = [bindings[0]]
        for j, jb in zip(sel.joins, bindings[1:]):
            lscope = Scope(
                tables={b: dict(sch.types) for b, _, sch in left_bindings},
            )
            rscope = Scope(tables={jb[0]: dict(jb[2].types)})
            eq_pairs, residual = self._split_on(j.on, lscope, rscope)
            join_plans.append((j, jb, eq_pairs, residual))
            left_bindings.append(jb)

        # record the lowering decisions per site (cost-model metadata):
        # the left side of site 0 is the base table; every later site
        # reads the previous site's capacity-bounded output
        join_sites: List[JoinSite] = []
        left_rows = base_cap
        for j, jb, eq_pairs, residual in join_plans:
            join_sites.append(JoinSite(
                kind=j.kind,
                right_table=jb[1],
                left_rows=left_rows,
                right_rows=self.capacities[jb[1]],
                out_rows=out_cap,
                algorithm="match-matrix" if residual is not None
                else "sort-merge",
                n_eq_keys=len(eq_pairs),
                has_residual=residual is not None,
            ))
            left_rows = out_cap

        def build(tables, base_s, now_rel_ms):
            # the left side accumulates as one merged column dict keyed
            # by (binding, col)
            b0, n0, sch0 = bindings[0]
            acc_cols = {(b0, c): tables[n0].cols[c] for c in sch0.types}
            acc_valid = tables[n0].valid
            acc_dropped = torch.zeros((), dtype=torch.int32, device=acc_valid.device)

            for j, jb, eq_pairs, residual in join_plans:
                rb, rn, _rsch = jb
                right = tables[rn]
                aux_tables = tables.get("__aux", {})
                lscopes = {"__aux": aux_tables}
                for (b, c), arr in acc_cols.items():
                    lscopes.setdefault(b, {})[c] = arr
                lenv = EvalEnv(lscopes, base_s, now_rel_ms, acc_valid.shape)
                renv = EvalEnv(
                    {rb: right.cols, "__aux": aux_tables},
                    base_s, now_rel_ms, right.valid.shape,
                )
                lkeys = [le.fn(lenv) for le, _ in eq_pairs]
                rkeys = [re_.fn(renv) for _, re_ in eq_pairs]

                res_fn = None
                if residual is not None:
                    def res_fn(li, ri, residual=residual, lscopes=lscopes,
                               right=right, rb=rb, aux_tables=aux_tables):
                        pl_scopes = {
                            b: {c: arr[li] for c, arr in cols.items()}
                            for b, cols in lscopes.items()
                            if b != "__aux"
                        }
                        pl_scopes[rb] = {c: arr[ri] for c, arr in right.cols.items()}
                        pl_scopes["__aux"] = aux_tables
                        env2 = EvalEnv(pl_scopes, base_s, now_rel_ms, li.shape)
                        return residual.fn(env2)

                if res_fn is None:
                    # pure equi-join: sort-merge, O((n+m+cap) log), the
                    # path that keeps batch x windowed-table joins off
                    # the O(n*m) match-matrix cliff
                    li, ri, valid, is_null, dropped = sort_join_indices(
                        lkeys, rkeys, acc_valid, right.valid, out_cap,
                        left_outer=(j.kind == "LEFT"),
                    )
                    if j.kind != "LEFT":
                        is_null = None
                elif j.kind == "LEFT":
                    li, ri, valid, is_null, dropped = left_join_indices(
                        lkeys, rkeys, acc_valid, right.valid, out_cap, res_fn
                    )
                else:
                    li, ri, valid, dropped = inner_join_indices(
                        lkeys, rkeys, acc_valid, right.valid, out_cap, res_fn
                    )
                    is_null = None
                acc_dropped = acc_dropped + dropped

                new_cols = {}
                for (b, c), arr in acc_cols.items():
                    new_cols[(b, c)] = arr[li]
                for c, arr in right.cols.items():
                    gathered = arr[ri]
                    if is_null is not None:
                        # a LEFT join's unmatched rows carry NULL (0) on
                        # the right side
                        gathered = torch.where(
                            is_null, torch.zeros_like(gathered), gathered
                        )
                    new_cols[(rb, c)] = gathered
                acc_cols = new_cols
                acc_valid = valid

            # merge to final names under a single "" binding + per-binding
            final_scopes: Dict[str, Dict[str, torch.Tensor]] = {"": {}}
            for (b, c), arr in acc_cols.items():
                final_scopes[""][merged_name(b, c)] = arr
                final_scopes.setdefault(b, {})[c] = arr
            # pairs lost to the join capacity bound ride along as scope
            # metadata (never row-shaped) so the output view can surface
            # them as an overflow column for the runtime's metric
            final_scopes["__meta"] = {"join_dropped": acc_dropped}
            return final_scopes, acc_valid, acc_valid.shape

        # scope: merged columns under "" plus per-binding scopes
        scope_tables = {"": dict(merged_types)}
        scope_deferred = {"": self._deferred_exprs("", merged_schema)}
        for b, _, sch in bindings:
            scope_tables[b] = dict(sch.types)
            scope_deferred[b] = self._deferred_exprs(b, sch)
        scope = Scope(tables=scope_tables, deferred=scope_deferred)
        return scope, build, out_cap, join_sites

    def _join_capacity(self, sel: Select) -> int:
        if self.config.join_capacity is not None:
            return self.config.join_capacity
        caps = [self.capacities[sel.from_table.name]] + [
            self.capacities[j.table.name] for j in sel.joins
        ]
        return max(64, max(caps))

    def _split_on(self, on: Expr, lscope: Scope, rscope: Scope):
        """Split ON into equi pairs (left expr, right expr) + residual."""
        conjuncts: List[Expr] = []

        def walk(e: Expr):
            if isinstance(e, BinOp) and e.op == "AND":
                walk(e.left)
                walk(e.right)
            else:
                conjuncts.append(e)

        walk(on)
        eq_pairs = []
        residual_parts: List[Expr] = []
        for c in conjuncts:
            if isinstance(c, BinOp) and c.op == "=":
                sides = [self._side_of(s, lscope, rscope) for s in (c.left, c.right)]
                if sides == ["L", "R"]:
                    eq_pairs.append((c.left, c.right))
                    continue
                if sides == ["R", "L"]:
                    eq_pairs.append((c.right, c.left))
                    continue
            residual_parts.append(c)
        if not eq_pairs:
            raise EngineException(
                "JOIN requires at least one equality between the two tables"
            )
        compiled_pairs = []
        for le, re_ in eq_pairs:
            lc = self._expr_compiler(lscope)
            rc = self._expr_compiler(rscope)
            lv = lc.compile(le)
            rv = rc.compile(re_)
            if isinstance(lv, HostStr) or isinstance(rv, HostStr):
                # computed-string join key: equate the device hash pair;
                # a third pair tags NULLs differently per side so a NULL
                # key never matches anything (SQL join semantics)
                lk = lc.hash_keys(lv)
                rk = rc.hash_keys(rv)
                if lk is None or rk is None:
                    raise EngineException(
                        "JOIN on a computed string requires both sides "
                        "built from string columns/literals: "
                        f"{le!r} = {re_!r}"
                    )
                compiled_pairs.append((lk[0], rk[0]))
                compiled_pairs.append((lk[1], rk[1]))
                compiled_pairs.append(
                    (_null_tag(lk[2], 1), _null_tag(rk[2], 2))
                )
            else:
                for v, side in ((lv, "left"), (rv, "right")):
                    if not is_device(v):
                        raise EngineException(
                            f"JOIN {side} key must be device-computable: "
                            f"{le!r} = {re_!r}"
                        )
                compiled_pairs.append((lv, rv))
        residual = None
        if residual_parts:
            expr = residual_parts[0]
            for p in residual_parts[1:]:
                expr = BinOp("AND", expr, p)
            both = Scope(tables={**lscope.tables, **rscope.tables})
            residual = self._expr_compiler(both).compile_device(expr)
        return compiled_pairs, residual

    def _side_of(self, e: Expr, lscope: Scope, rscope: Scope) -> str:
        """Which side an expression's columns come from: 'L', 'R', or '?'."""
        cols: List[Col] = []

        def walk(x):
            if isinstance(x, Col):
                cols.append(x)
            for attr in ("left", "right", "operand", "expr"):
                sub = getattr(x, attr, None)
                if sub is not None and not isinstance(sub, (str, tuple)):
                    walk(sub)
            if isinstance(x, Func):
                for a in x.args:
                    if not isinstance(a, Star):
                        walk(a)

        walk(e)
        if not cols:
            return "?"
        sides = set()
        for c in cols:
            inl = self._resolves(lscope, c)
            inr = self._resolves(rscope, c)
            if inl and not inr:
                sides.add("L")
            elif inr and not inl:
                sides.add("R")
            else:
                sides.add("?")
        return sides.pop() if len(sides) == 1 else "?"

    @staticmethod
    def _resolves(scope: Scope, c: Col) -> bool:
        try:
            scope.resolve(c.parts)
            return True
        except EngineException:
            return False

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
        plan = view.plan
        if plan is not None:
            plan = replace(
                plan, output_rows=capacity,
                order_keys=len(keys), limit=limit,
            )
        return CompiledView(
            view.name, view.schema, capacity, run,
            select_values=view.select_values,
            plan=plan,
        )

    # -- grouped path ----------------------------------------------------
    def _compile_grouped(
        self, name, sel, scope, compiler, build_scope, scope_capacity,
        where_fn, out_types, deferred, flat_outputs, out_values,
        having_fn=None, join_sites=(),
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
                # dictionary tables and join metadata are not row-shaped
                if b not in ("__aux", "__meta")
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
            meta = scopes.get("__meta")
            if meta is not None and "join_dropped" in meta:
                cols["__overflow.joins"] = meta["join_dropped"].expand(capacity)
            return TableData(cols, out_valid)

        schema = ViewSchema(out_types, deferred)
        return CompiledView(
            name, schema, capacity, run,
            plan=StagePlan(
                kind="group",
                input_rows=scope_capacity,
                output_rows=capacity,
                joins=tuple(join_sites),
                grouped=True,
                group_keys=len(key_compiled),
                group_key_cols=tuple(sorted({
                    c for k in key_compiled for (_b, c) in k.deps
                })),
                n_aggregates=len(agg_nodes) + len(udaf_nodes),
                groups_bound=capacity,
            ),
        )


def _null_tag(null_expr: CompiledExpr, tag: int) -> CompiledExpr:
    """0 for non-null rows, a per-side tag for null rows — joined as an
    extra equality key so null never equals null across sides."""

    def run(env, n=null_expr, tag=tag):
        return torch.where(n.fn(env), tag, 0).to(torch.int32)

    return CompiledExpr("long", run, deps=null_expr.deps)


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
