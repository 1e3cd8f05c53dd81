"""UDF static analyzer: host-sync safety, purity and determinism lints.

The port's ``--udfs`` analysis tier, the torch rewrite of the JAX
package's ``analysis/udfcheck.py``. It checks what a flow's user code
*does*: it resolves every declared UDF/UDAF through the production
loader (``udf/api.py:load_udfs_from_conf``, the same reflection path the
runtime uses) and abstract-interprets the device functions' Python ASTs
(``inspect.getsource`` + ``ast``) under a two-point taint lattice: an
argument is a DEVICE tensor, anything derived from one stays DEVICE,
everything else is HOST. The DX3xx family falls out of where DEVICE
values flow. PyTorch runs eagerly, so a hazard that makes a JAX trace
fail makes an eager step read back from the device instead:

- **DX300** — DEVICE value in a Python control-flow position
  (``if``/``while``/``assert``/``not``/short-circuit ``and``/``or``/
  ``range()``): ``Tensor.__bool__`` copies the value to the host and
  blocks on the stream every batch, and a step that does so cannot be
  captured in a CUDA graph.
- **DX301** — host sync point (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()``/``int()``/``bool()``, ``np.asarray``) on a
  DEVICE value, or ``torch.cuda.synchronize()``: the same blocking read.
- **DX302** — impurity: mutating global/closure state, I/O, ``time.*``,
  host randomness, or torch's global generator where an explicit
  ``torch.Generator`` belongs. Eager PyTorch repeats the effect on every
  batch (the JAX package runs it once, at trace time); either way the
  result depends on state outside the batch.
- **DX303** — captured mutable state with no ``on_interval`` declared.
  Eager PyTorch reads the state on every call, so an update lands in
  whatever batch is running (the JAX package would serve it stale).
- **DX304** — declared ``out_type`` inconsistent with the return dtype
  inferred under a small dtype lattice (float/int/bool).
- **DX305** — CUDA launch hazards at ``cuda_call`` (``kernels/
  launch.py``): no ``out_shape``, or ``grid``/``out_shape`` derived from
  DEVICE values or from values read back from them. A read-back that
  only feeds a launch spec is reported once, as DX305.
- **DX310** — the conf entry itself does not load: bad
  ``package.module:attr``, non-callable target, aggregate without
  ``reduce``, duplicate declaration.

Verdicts are ground-truthed: ``tests/test_torch_udfcheck.py`` pairs each
code's golden fixture with a runtime test showing that the flagged UDF
really syncs, raises or misbehaves while its clean twin does not.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from ..core.config import EngineException, SettingDictionary
from .diagnostics import Diagnostic, Span, make

# tensor attributes that are metadata on the host (safe to branch on)
_STATIC_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "layout",
    "requires_grad", "itemsize", "nbytes",
}
# tensor methods that read metadata only, never device memory
_STATIC_METHODS = {
    "dim", "size", "numel", "nelement", "is_contiguous", "data_ptr",
    "element_size", "stride", "storage_offset", "get_device",
    "is_floating_point", "is_complex",
}
# builtins whose result is host metadata even of a tensor
_STATIC_FNS = {"len", "isinstance", "type", "id"}

# method calls that copy a device receiver to the host and block
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# builtins that read a device tensor back (DX301) or bool-convert its
# elements (DX300)
_HOST_CASTS = {"float", "int", "bool", "complex"}
_BOOL_BUILTINS = {"any", "all", "max", "min", "sorted", "range"}

# container-mutating method names (on a captured object -> impurity);
# torch's in-place methods (``add_``) mutate a captured tensor too
_MUTATORS = {
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "remove", "discard", "clear", "setdefault", "write", "writelines",
}

# plain-name calls that do I/O
_IO_CALLS = {"open", "print", "input"}

# dotted-call prefixes that make a device function nondeterministic or
# wall-clock dependent
_NONDET_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.", "secrets.",
    "uuid.", "os.urandom", "datetime.",
)

# torch random draws: from the global generator unless ``generator=``
_TORCH_RANDOM = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
}
_TORCH_RANDOM_INPLACE = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
}
_TORCH_RESEED = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed"}

# numpy conversion entry points that read a tensor back to the host
_NP_CONVERTERS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "np.copy", "numpy.copy", "np.float32", "np.float64", "np.int32",
    "np.int64",
}

# declared SQL out_type -> dtype-lattice point
_DECLARED_DTYPE = {
    "double": "float", "float": "float",
    "long": "int", "int": "int", "integer": "int", "bigint": "int",
    "boolean": "bool", "bool": "bool",
}

# torch function name -> result lattice point (by final attr segment)
_FLOAT_FNS = {
    "exp", "expm1", "log", "log1p", "log2", "log10", "sqrt", "rsqrt",
    "sin", "cos", "tan", "tanh", "sinh", "cosh", "asin", "acos", "atan",
    "atan2", "arcsin", "arccos", "arctan", "arctan2", "sigmoid", "softmax",
    "log_softmax", "logaddexp", "erf", "reciprocal", "true_divide",
    "mean", "var", "std", "linspace",
}
_BOOL_FNS = {
    "isfinite", "isnan", "isinf", "isclose", "logical_and", "logical_or",
    "logical_not", "logical_xor", "eq", "ne", "gt", "lt", "ge", "le",
    "greater", "less", "greater_equal", "less_equal", "not_equal",
}
_DTYPE_NAMES = {
    "float16": "float", "bfloat16": "float", "float32": "float",
    "float64": "float", "half": "float", "float": "float",
    "double": "float",
    "int8": "int", "int16": "int", "int32": "int", "int64": "int",
    "uint8": "int", "short": "int", "int": "int", "long": "int",
    "bool": "bool",
}
# tensor methods that convert to a fixed dtype: x.float(), x.long(), ...
_CAST_METHODS = {
    "float": "float", "double": "float", "half": "float",
    "bfloat16": "float", "int": "int", "long": "int", "short": "int",
    "char": "int", "byte": "int", "bool": "bool",
}
_CONSTRUCTORS = {
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "tensor", "as_tensor",
}


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; "" when
    not a plain dotted name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ---------------------------------------------------------------------------
# Source resolution: callable -> AST node (+ absolute line numbers)
# ---------------------------------------------------------------------------
def _fn_node(fn) -> Optional[ast.AST]:
    """AST of a function/lambda's definition, or None when source is
    unavailable (C functions, exec'd code). Prefers parsing the whole
    defining file and locating the node by line number — that handles
    lambdas embedded mid-expression and keeps ``Span.line`` pointing at
    real module lines."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    tree = None
    try:
        lines, _ = inspect.findsource(code)
        tree = ast.parse("".join(lines))
    except (OSError, TypeError, SyntaxError):
        tree = None
    if tree is not None:
        want = code.co_firstlineno
        best = None
        for n in ast.walk(tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if n.name != code.co_name:
                    continue
            elif isinstance(n, ast.Lambda):
                if code.co_name != "<lambda>":
                    continue
            else:
                continue
            if n.lineno > want or (n.end_lineno or n.lineno) < want:
                continue
            if best is None or n.lineno > best.lineno:
                best = n
        if best is not None:
            return best
    # fallback: the function's own source block (dynamically defined
    # functions pytest writes to temp files, doctests, ...)
    try:
        src = textwrap.dedent(inspect.getsource(fn)).strip().rstrip(",")
    except (OSError, TypeError):
        return None
    try:
        mod = ast.parse(src)
    except SyntaxError:
        return None
    for n in ast.walk(mod):
        if isinstance(n, (ast.FunctionDef, ast.Lambda)):
            return n
    return None


def _param_names(node: ast.AST) -> List[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _local_names(node: ast.AST) -> set:
    """Every name the function binds locally (params, ``self`` included,
    + assignment targets) — writes to anything else mutate captured
    state. A wrapper's writes to ``self`` (its launch count) are its own
    state, which eager PyTorch updates on every call."""
    out = set(_param_names(node))
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not node:
            out.add(n.name)
        elif isinstance(n, ast.comprehension):
            for t in ast.walk(n.target):
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for alias in n.names:
                out.add((alias.asname or alias.name).split(".")[0])
    return out


# ---------------------------------------------------------------------------
# The per-function abstract interpreter
# ---------------------------------------------------------------------------
class _FnLinter:
    """One device function's taint walk. ``tainted`` holds names bound
    to DEVICE values; ``synced`` maps names bound to values read back
    from the device to the DX301 findings that read them. Findings
    dedupe on (code, line, message) so loop bodies can be walked twice
    for a cheap taint fixpoint."""

    def __init__(self, node: ast.AST, udf_name: str, role: str,
                 untraced_params: Sequence[str] = ()):
        self.node = node
        self.udf = udf_name
        self.role = role
        self.tainted = {
            p for p in _param_names(node)
            if p not in untraced_params and p != "self"
        }
        self.locals = _local_names(node)
        self.escaping: set = set()  # global/nonlocal declarations
        self.dtypes: Dict[str, Optional[str]] = {}
        self.return_dtypes: List[Optional[str]] = []
        self.synced: Dict[str, FrozenSet[tuple]] = {}
        self._cast_keys: Dict[int, tuple] = {}  # id(cast call) -> DX301 key
        self._consumed: set = set()  # DX301 keys reported as DX305
        self._found: Dict[tuple, Diagnostic] = {}

    @property
    def diags(self) -> List[Diagnostic]:
        return [d for k, d in self._found.items() if k not in self._consumed]

    # -- reporting -------------------------------------------------------
    def _emit(self, code: str, node: ast.AST, message: str) -> tuple:
        key = (code, getattr(node, "lineno", 0), message)
        if key not in self._found:
            self._found[key] = make(
                code, self.udf, f"{self.role}: {message}",
                Span(line=getattr(node, "lineno", 0)),
            )
        return key

    # -- entry -----------------------------------------------------------
    def run(self) -> "_FnLinter":
        if isinstance(self.node, ast.Lambda):
            dt = self._expr(self.node.body)
            self.return_dtypes.append(dt)
        else:
            self._stmts(self.node.body)
            # second pass settles taint that loops feed back
            self._stmts(self.node.body)
        return self

    # -- statements ------------------------------------------------------
    def _stmts(self, body: List[ast.stmt]) -> None:
        for s in body:
            self._stmt(s)

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.Global, ast.Nonlocal)):
            self.escaping.update(s.names)
        elif isinstance(s, ast.Assign):
            dt = self._expr(s.value)
            taint = self._taint(s.value)
            origins = self._origins(s.value)
            for t in s.targets:
                self._assign_target(t, taint, dt, s, origins)
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            dt = self._expr(s.value)
            self._assign_target(s.target, self._taint(s.value), dt, s,
                                self._origins(s.value))
        elif isinstance(s, ast.AugAssign):
            self._expr(s.value)
            taint = self._taint(s.value) or self._taint(s.target)
            self._assign_target(s.target, taint, None, s,
                                self._origins(s.value) | self._origins(s.target))
        elif isinstance(s, ast.If):
            self._expr(s.test)
            if self._taint(s.test):
                self._emit(
                    "DX300", s,
                    "`if` on a device tensor calls Tensor.__bool__, a "
                    "blocking read to the host every batch that also "
                    "rules out CUDA-graph capture; use torch.where",
                )
            self._stmts(s.body)
            self._stmts(s.orelse)
        elif isinstance(s, ast.While):
            self._expr(s.test)
            if self._taint(s.test):
                self._emit(
                    "DX300", s,
                    "`while` on a device tensor reads it back to the "
                    "host on every iteration; bound the loop by static "
                    "shapes or compute with masks",
                )
            self._stmts(s.body)
            self._stmts(s.orelse)
        elif isinstance(s, ast.For):
            self._expr(s.iter)
            self._assign_target(s.target, self._taint(s.iter), None, s,
                                self._origins(s.iter))
            self._stmts(s.body)
            self._stmts(s.orelse)
        elif isinstance(s, ast.Assert):
            self._expr(s.test)
            if self._taint(s.test):
                self._emit(
                    "DX300", s,
                    "`assert` on a device tensor reads it back to the "
                    "host every batch; drop the assert or check outside "
                    "the step",
                )
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self.return_dtypes.append(self._expr(s.value))
        elif isinstance(s, ast.Expr):
            self._expr(s.value)
        elif isinstance(s, ast.With):
            for item in s.items:
                self._expr(item.context_expr)
            self._stmts(s.body)
        elif isinstance(s, ast.Try):
            self._stmts(s.body)
            for h in s.handlers:
                self._stmts(h.body)
            self._stmts(s.orelse)
            self._stmts(s.finalbody)
        # nested defs run when called (out of scope); Import/Pass/Raise:
        # nothing to do

    def _assign_target(self, t: ast.expr, taint: bool, dt: Optional[str],
                       stmt: ast.stmt, origins: FrozenSet[tuple]) -> None:
        if isinstance(t, ast.Name):
            if t.id in self.escaping:
                self._emit(
                    "DX302", stmt,
                    f"writes global/nonlocal '{t.id}' — the write repeats "
                    "every batch, so results depend on state outside "
                    "the batch",
                )
            if taint:
                self.tainted.add(t.id)
            else:
                self.tainted.discard(t.id)
            if origins:
                self.synced[t.id] = origins
            else:
                self.synced.pop(t.id, None)
            self.dtypes[t.id] = dt
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._assign_target(el, taint, None, stmt, origins)
        elif isinstance(t, (ast.Subscript, ast.Attribute)):
            base = t.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and base.id not in self.locals:
                self._emit(
                    "DX302", stmt,
                    f"mutates captured object '{base.id}' — the write "
                    "repeats every batch; pure functions + on_interval "
                    "refresh is the supported pattern",
                )
            if isinstance(t, ast.Subscript):
                self._expr(t.slice)

    # -- expressions -------------------------------------------------------
    def _taint(self, e: ast.expr) -> bool:
        """Is this expression a DEVICE value or derived from one? (Pure
        query — no diagnostics; ``_expr`` must already have walked it.)"""
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self._taint(e.value)
        if isinstance(e, ast.Subscript):
            return self._taint(e.value) or self._taint(e.slice)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self._taint(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(
                self._taint(x) for x in (*e.keys, *e.values) if x is not None
            )
        if isinstance(e, ast.BinOp):
            return self._taint(e.left) or self._taint(e.right)
        if isinstance(e, ast.UnaryOp):
            return self._taint(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self._taint(v) for v in e.values)
        if isinstance(e, ast.Compare):
            return self._taint(e.left) or any(
                self._taint(c) for c in e.comparators
            )
        if isinstance(e, ast.IfExp):
            return (
                self._taint(e.test) or self._taint(e.body)
                or self._taint(e.orelse)
            )
        if isinstance(e, ast.Call):
            dotted = _dotted(e.func)
            if (dotted in _HOST_CASTS or dotted in _NP_CONVERTERS
                    or dotted in _STATIC_FNS):
                # a host value: a read-back is flagged where it is made
                # (and tracked in ``synced``), so downstream use does
                # not re-report
                return False
            if (isinstance(e.func, ast.Attribute)
                    and e.func.attr in _STATIC_METHODS | _SYNC_METHODS):
                return False
            return (
                self._taint(e.func)
                or any(self._taint(a) for a in e.args)
                or any(self._taint(k.value) for k in e.keywords)
            )
        if isinstance(e, ast.Starred):
            return self._taint(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return any(self._taint(g.iter) for g in e.generators) or \
                self._taint(e.elt)
        if isinstance(e, ast.DictComp):
            return any(self._taint(g.iter) for g in e.generators)
        if isinstance(e, ast.JoinedStr):
            return any(
                self._taint(v.value) for v in e.values
                if isinstance(v, ast.FormattedValue)
            )
        if isinstance(e, ast.Slice):
            return any(
                self._taint(x) for x in (e.lower, e.upper, e.step)
                if x is not None
            )
        return False

    def _origins(self, e: Optional[ast.expr]) -> FrozenSet[tuple]:
        """The DX301 read-backs this expression's value comes from."""
        if e is None:
            return frozenset()
        out = set()
        for n in ast.walk(e):
            if isinstance(n, ast.Name) and n.id in self.synced:
                out |= self.synced[n.id]
            elif isinstance(n, ast.Call) and id(n) in self._cast_keys:
                out.add(self._cast_keys[id(n)])
        return frozenset(out)

    def _expr(self, e: ast.expr) -> Optional[str]:
        """Walk an expression emitting diagnostics; returns its dtype
        lattice point (float/int/bool/None)."""
        if isinstance(e, ast.Constant):
            if isinstance(e.value, bool):
                return "bool"
            if isinstance(e.value, int):
                return "int"
            if isinstance(e.value, float):
                return "float"
            return None
        if isinstance(e, ast.Name):
            return self.dtypes.get(e.id)
        if isinstance(e, ast.Attribute):
            self._expr(e.value)
            return _DTYPE_NAMES.get(e.attr)
        if isinstance(e, ast.Subscript):
            dt = self._expr(e.value)
            self._expr(e.slice)
            return dt
        if isinstance(e, ast.BinOp):
            l, r = self._expr(e.left), self._expr(e.right)
            if isinstance(e.op, ast.Div):
                return "float"
            return _join_dtype(l, r)
        if isinstance(e, ast.UnaryOp):
            dt = self._expr(e.operand)
            if isinstance(e.op, ast.Not):
                if self._taint(e.operand):
                    self._emit(
                        "DX300", e,
                        "`not` on a device tensor calls Tensor.__bool__, "
                        "a blocking read to the host; use "
                        "torch.logical_not",
                    )
                return "bool"
            return dt
        if isinstance(e, ast.BoolOp):
            for v in e.values:
                self._expr(v)
            if any(self._taint(v) for v in e.values):
                self._emit(
                    "DX300", e,
                    "short-circuit and/or on a device tensor calls "
                    "Tensor.__bool__, a blocking read to the host; use "
                    "& / | (torch.logical_and/or)",
                )
            return "bool"
        if isinstance(e, ast.Compare):
            self._expr(e.left)
            for c in e.comparators:
                self._expr(c)
            return "bool"
        if isinstance(e, ast.IfExp):
            self._expr(e.test)
            if self._taint(e.test):
                self._emit(
                    "DX300", e,
                    "conditional expression on a device tensor calls "
                    "Tensor.__bool__, a blocking read to the host; use "
                    "torch.where",
                )
            return _join_dtype(self._expr(e.body), self._expr(e.orelse))
        if isinstance(e, ast.Call):
            return self._call(e)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            for x in e.elts:
                self._expr(x)
            return None
        if isinstance(e, ast.Dict):
            for x in (*e.keys, *e.values):
                if x is not None:
                    self._expr(x)
            return None
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            for g in e.generators:
                self._expr(g.iter)
                if self._taint(g.iter):
                    for t in ast.walk(g.target):
                        if isinstance(t, ast.Name):
                            self.tainted.add(t.id)
            if isinstance(e, ast.DictComp):
                self._expr(e.key)
                self._expr(e.value)
            else:
                self._expr(e.elt)
            return None
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue):
                    self._expr(v.value)
            return None
        if isinstance(e, ast.Starred):
            return self._expr(e.value)
        if isinstance(e, ast.Slice):
            for x in (e.lower, e.upper, e.step):
                if x is not None:
                    self._expr(x)
            return None
        return None  # lambdas and the rest: analyzed in place or not at all

    # -- calls: where most DX3xx findings live --------------------------
    def _call(self, e: ast.Call) -> Optional[str]:
        dotted = _dotted(e.func)
        args_tainted = (
            any(self._taint(a) for a in e.args)
            or any(self._taint(k.value) for k in e.keywords)
        )

        # walk children first so nested calls report too
        for a in e.args:
            self._expr(a)
        kw = {}
        for k in e.keywords:
            self._expr(k.value)
            if k.arg:
                kw[k.arg] = k.value

        if isinstance(e.func, ast.Attribute):
            method = e.func.attr
            receiver = e.func.value
            # method-style sync points: x.item(), x.cpu(), x.to("cpu"), ...
            to_cpu = method == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in (*e.args, kw.get("device"))
            )
            if (method in _SYNC_METHODS or to_cpu) and self._taint(receiver):
                self._emit(
                    "DX301", e,
                    f".{method}() on a device tensor copies it to the "
                    "host and blocks every batch",
                )
            if method == "synchronize":
                self._emit(
                    "DX301", e,
                    ".synchronize() blocks the host on the device every "
                    "batch",
                )
            if method in _TORCH_RANDOM_INPLACE and "generator" not in kw:
                self._emit(
                    "DX302", e,
                    f".{method}() draws from torch's global generator, "
                    "shared with every other caller in the process; "
                    "pass generator=torch.Generator(...)",
                )
            if (
                (method in _MUTATORS
                 or (method.endswith("_") and not method.startswith("_")))
                and not self._taint(receiver)
            ):
                base = receiver
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id not in self.locals:
                    self._emit(
                        "DX302", e,
                        f"mutating call .{method}() on captured object "
                        f"'{base.id}' repeats every batch, so results "
                        "depend on state outside the batch",
                    )
            if method in ("to", "type"):
                self._expr(receiver)
                for a in (*e.args, kw.get("dtype")):
                    dt = self._dtype_of_node(a)
                    if dt is not None:
                        return dt
                return self._expr(receiver)  # a device move keeps the dtype
            if method in _CAST_METHODS and not e.args:
                self._expr(receiver)
                return _CAST_METHODS[method]

        # builtin read-backs / bool-converters
        if dotted in _HOST_CASTS and args_tainted:
            key = self._emit(
                "DX301", e,
                f"{dotted}() of a device tensor copies it to the host and "
                "blocks every batch; keep it a tensor",
            )
            self._cast_keys[id(e)] = key
            return "float" if dotted == "float" else (
                "bool" if dotted == "bool" else "int")
        if dotted in _BOOL_BUILTINS and args_tainted:
            self._emit(
                "DX300", e,
                f"{dotted}() over a device tensor bool-converts its "
                "elements on the host; use the torch equivalent",
            )
            return None
        if dotted in _NP_CONVERTERS and args_tainted:
            self._emit(
                "DX301", e,
                f"{dotted}() of a device tensor copies it to the host "
                "(or fails on a CUDA tensor); use torch instead of np",
            )
            return None
        if dotted == "torch.cuda.synchronize":
            self._emit(
                "DX301", e,
                "torch.cuda.synchronize() blocks the host on the device "
                "every batch",
            )
            return None

        # impurity: I/O, host randomness/clock, torch's global generator
        if dotted in _IO_CALLS:
            self._emit(
                "DX302", e,
                f"{dotted}() is I/O — it runs on every batch, on the "
                "step's critical path",
            )
            return None
        if dotted in _TORCH_RESEED or (
            dotted.startswith("torch.")
            and dotted.rsplit(".", 1)[-1] in _TORCH_RANDOM
            and "generator" not in kw
        ):
            self._emit(
                "DX302", e,
                f"{dotted}() uses torch's global generator, shared with "
                "every other caller in the process; pass "
                "generator=torch.Generator(...) seeded from on_interval "
                "state",
            )
            return None
        if dotted and not dotted.startswith("torch."):
            for p in _NONDET_PREFIXES:
                if dotted == p.rstrip(".") or dotted.startswith(p):
                    self._emit(
                        "DX302", e,
                        f"{dotted}() draws host entropy/wall-clock on "
                        "every batch, so results cannot be replayed; use "
                        "a seeded torch.Generator (or on_interval state)",
                    )
                    return None

        # CUDA launch hazards at a user-written cuda_call
        if dotted == "cuda_call" or dotted.endswith(".cuda_call"):
            self._cuda_call(e, kw)
            return None

        self._expr(e.func)

        # dtype inference for the common torch constructors/math
        leaf = dotted.rsplit(".", 1)[-1] if dotted else ""
        if leaf in _FLOAT_FNS:
            return "float"
        if leaf in _BOOL_FNS:
            return "bool"
        if leaf in _CONSTRUCTORS:
            if "dtype" in kw:
                return self._dtype_of_node(kw["dtype"])
            return None
        if leaf == "where" and len(e.args) == 3:
            return _join_dtype(
                self._expr(e.args[1]), self._expr(e.args[2])
            )
        return None

    def _dtype_of_node(self, n: Optional[ast.expr]) -> Optional[str]:
        if n is None:
            return None
        d = _dotted(n)
        if d:
            if not d.startswith("torch."):
                return None
            return _DTYPE_NAMES.get(d.rsplit(".", 1)[-1])
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            return _DTYPE_NAMES.get(n.value)
        return None

    def _cuda_call(self, e: ast.Call, kw: Dict[str, ast.expr]) -> None:
        """Hazards at a user-written ``cuda_call`` site."""
        splat = any(k.arg is None for k in e.keywords)
        if "out_shape" not in kw and not splat:
            self._emit(
                "DX305", e,
                "cuda_call without out_shape — there is no output to "
                "allocate, and the call raises TypeError; pass "
                "out_shape=x.shape",
            )
        for key in ("grid", "out_shape"):
            node = kw.get(key)
            if node is None:
                continue
            if self._taint(node):
                self._emit(
                    "DX305", e,
                    f"cuda_call {key}= derived from a device tensor — "
                    "launch specs are Python ints; derive them from "
                    ".shape/.numel(), not from tensor contents",
                )
                continue
            origins = self._origins(node)
            if origins:
                lines = sorted({line for _, line, _ in origins})
                self._emit(
                    "DX305", e,
                    f"cuda_call {key}= read back from tensor contents "
                    f"(line {', '.join(map(str, lines))}), a blocking "
                    "read to the host every batch; derive it from "
                    ".shape/.numel()",
                )
                self._consumed |= origins


def _join_dtype(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a == b:
        return a
    if {a, b} == {"int", "float"}:
        return "float"
    return None


# ---------------------------------------------------------------------------
# Object-level checks (closure introspection + out_type lattice)
# ---------------------------------------------------------------------------
def _captured_mutable(fn) -> List[str]:
    """Names of mutable containers the function closes over or reads
    from module globals — the state ``on_interval`` exists to refresh."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return []
    out = []
    for var, cell in zip(code.co_freevars, getattr(fn, "__closure__", None) or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if isinstance(v, (dict, list, set, bytearray)):
            out.append(var)
    g = getattr(fn, "__globals__", {})
    for var in code.co_names:
        if var in g and isinstance(g[var], (dict, list, set, bytearray)):
            out.append(var)
    return sorted(set(out))


def _declares_interval(obj) -> bool:
    """True when the UDF declares a refresh hook: a non-None
    ``_on_interval`` (the TorchUdf surface) or an ``on_interval`` the
    object's own class defines (duck-typed UDFs)."""
    if getattr(obj, "_on_interval", None) is not None:
        return True
    from ..udf import api as _api

    for klass in type(obj).__mro__:
        if "on_interval" in vars(klass):
            return klass.__module__ != _api.__name__
    return False


def _device_fns(obj) -> List[Tuple[str, object, Tuple[str, ...]]]:
    """(role, callable, untraced param names) per device function of a
    UDF object. A ``CudaKernelUdf`` analyzes its kernel launcher (its
    ``fn`` is the library's own dispatch; the kernel itself is CUDA
    C++): a function, or a wrapper object's ``__call__``. Scalar UDFs
    analyze ``fn``; aggregates analyze ``reduce`` (``capacity`` is a
    static Python int by contract)."""
    kernel = getattr(obj, "kernel", None)
    if callable(kernel):
        if not hasattr(kernel, "__code__"):
            kernel = type(kernel).__call__
        return [("kernel", kernel, ())]
    out: List[Tuple[str, object, Tuple[str, ...]]] = []
    fn = getattr(obj, "fn", None)
    if callable(fn):
        out.append(("fn", fn, ()))
    red = getattr(obj, "reduce", None)
    if getattr(obj, "is_aggregate", False) and callable(red):
        out.append(("reduce", red, ("capacity",)))
    return out


def check_udf_object(
    obj, name: Optional[str] = None
) -> Tuple[List[Diagnostic], List[str]]:
    """Analyze one loaded UDF object; returns (diagnostics, roles
    analyzed). The self-lint path for ``udf/samples.py`` objects; the
    flow path (``analyze_flow_udfs``) adds the DX310 loader findings."""
    udf_name = name or getattr(obj, "name", "") or type(obj).__name__
    diags: List[Diagnostic] = []
    roles: List[str] = []
    ret_dtypes: List[Optional[str]] = []
    for role, fn, untraced in _device_fns(obj):
        node = _fn_node(fn)
        # DX303 needs no source — it reads the live closure
        captured = _captured_mutable(fn)
        if captured and not _declares_interval(obj):
            diags.append(make(
                "DX303", udf_name,
                f"{role}: captures mutable state {captured} with no "
                "on_interval declared — eager PyTorch reads it on every "
                "call, so an update lands in whatever batch is running, "
                "with no batch boundary or refresh",
                Span(line=node.lineno if node is not None else 0),
            ))
        if node is None:
            continue
        roles.append(role)
        lint = _FnLinter(
            node, udf_name, role, untraced_params=untraced
        ).run()
        diags.extend(lint.diags)
        if role in ("fn", "reduce"):
            ret_dtypes.extend(lint.return_dtypes)

    # DX304: declared out_type vs the inferred return dtype
    out_type = getattr(obj, "out_type", None)
    if isinstance(out_type, str):
        declared = _DECLARED_DTYPE.get(out_type.lower())
        known = {d for d in ret_dtypes if d is not None}
        if declared and len(known) == 1 and ret_dtypes and \
                all(d is not None for d in ret_dtypes):
            inferred = known.pop()
            if inferred != declared:
                diags.append(make(
                    "DX304", udf_name,
                    f"declared out_type '{out_type}' maps to {declared} "
                    f"but the function returns {inferred} under the "
                    "type lattice — results decode through the wrong "
                    "column type",
                ))
    return diags, roles


# ---------------------------------------------------------------------------
# Flow-level entry point (the production-loader path)
# ---------------------------------------------------------------------------
@dataclass
class UdfSummary:
    name: str
    tier: str  # udf | udaf
    path: str  # package.module:attr
    kind: str  # class name of the loaded object ("" when unloadable)
    analyzed: List[str] = field(default_factory=list)  # roles walked

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "tier": self.tier,
            "path": self.path,
            "kind": self.kind,
            "analyzed": list(self.analyzed),
        }


@dataclass
class UdfCheckReport:
    flow: str
    udfs: List[UdfSummary]
    diagnostics: List[Diagnostic]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def udfs_dict(self) -> dict:
        return {
            "flow": self.flow,
            "functions": [u.to_dict() for u in self.udfs],
        }

    def to_dict(self) -> dict:
        from .diagnostics import REPORT_SCHEMA_VERSION

        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "udfs": self.udfs_dict(),
        }


_UDF_TYPES = {"udf": "udf", "jarudf": "udf", "pythonudf": "udf",
              "udaf": "udaf", "jarudaf": "udaf"}


def analyze_flow_udfs(flow: dict) -> UdfCheckReport:
    """UDF-tier analysis of a flow config (gui JSON or full flow
    document): resolve every declared function through the PRODUCTION
    loader (``load_udfs_from_conf`` — same reflection path, same
    rejections), then abstract-interpret each device function's AST."""
    from ..udf.api import load_udfs_from_conf

    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    name = gui.get("name") or ""
    proc = gui.get("process") or {}
    diags: List[Diagnostic] = []
    summaries: List[UdfSummary] = []
    seen: Dict[str, str] = {}
    for entry in proc.get("functions") or []:
        ftype = (entry.get("type") or "udf").lower()
        tier = _UDF_TYPES.get(ftype)
        if tier is None:
            continue  # azure functions are a sink tier, not compiled
        fid = entry.get("id") or ""
        props = entry.get("properties") or {}
        path = props.get("module") or props.get("class") or ""
        if not fid or not path:
            diags.append(make(
                "DX310", fid,
                "ill-formed UDF conf entry: both id and "
                "properties.module (package.module:attr) are required",
            ))
            continue
        if fid.lower() in seen:
            diags.append(make(
                "DX310", fid,
                f"duplicate UDF name '{fid}' (also declared as "
                f"{seen[fid.lower()]}) — registration is "
                "case-insensitive and last-wins would silently shadow "
                "the first",
            ))
            continue
        seen[fid.lower()] = path
        conf = SettingDictionary({
            f"datax.job.process.jar.{tier}.{fid}.class": path,
        })
        try:
            obj = load_udfs_from_conf(conf)[fid.lower()]
        except EngineException as e:
            diags.append(make("DX310", fid, str(e)))
            summaries.append(UdfSummary(fid, tier, path, ""))
            continue
        if tier == "udaf" and not (
            getattr(obj, "is_aggregate", False)
            and callable(getattr(obj, "reduce", None))
        ):
            diags.append(make(
                "DX310", fid,
                f"udaf '{fid}' ({path}) is not an aggregate — it must "
                "set is_aggregate and provide reduce(arg_arrays, seg, "
                "capacity, valid_s)",
            ))
            summaries.append(
                UdfSummary(fid, tier, path, type(obj).__name__)
            )
            continue
        obj_diags, roles = check_udf_object(obj, name=fid)
        diags.extend(obj_diags)
        summaries.append(
            UdfSummary(fid, tier, path, type(obj).__name__, roles)
        )
    diags = sorted(
        diags, key=lambda d: (d.severity != "error", d.span.line, d.code)
    )
    return UdfCheckReport(name, summaries, diags)
