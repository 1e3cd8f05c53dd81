"""Static configuration-lattice analysis (the ``--conf`` tier).

The conf lattice — designer ``jobXxx`` knob → S400 gui token → S650
flat ``datax.job.process.*`` key → runtime ``conf.get`` fallback — is
the largest hand-plumbed interface in the repo, and it has broken
silently before (a designer knob once shipped whose conf key the
runtime never saw). This pass makes every hop checkable:

1. **Read-site scan** — every engine/serve module is AST-scanned for
   conf reads: typed getters on variables resolved (through
   ``get_sub_dictionary`` chains, ``SettingNamespace`` constants,
   module prefix constants, local wrapper helpers like
   ``lq/service.py:_conf_get`` and f-string families) to a
   ``datax.job.process.`` prefix, plus bulk family walks
   (``group_by_sub_namespace()`` / ``.dict``).
2. **Producer scan** — ``serve/generation.py``'s S400 token dictionary
   (knob→token, with generation defaults), the S640 knob→key tuple
   table, every ``extra["datax.job.process…"]`` S650 write, the
   declarative flattener template schema
   (``compile/flattener_schema.py`` — the reference-parity keys), and
   control-plane dict literals (scenarios, livequery, serve main).
3. **Lattice checks** against the ONE typed registry
   (``analysis/confspec.py``):

   - DX1000 — a read site's key matches no registry row: the runtime
     waits on a knob nothing can produce (dead knob / typo).
   - DX1001 — a produced key matches no registry row (or, in the
     full-tree self-lint, a registered read=True key has no read
     site): generated-but-never-read dead conf.
   - DX1002 — broken designer→runtime chain: an S400 gui token no
     generated key carries, or a registry row whose declared knob /
     key the generation scan cannot connect (that bug class as a
     standing gate).
   - DX1003 — default drift: a read-site fallback literal (or an S400
     generation default) disagrees with the registry's canonical
     default, so "unset" means different things on different layers.
   - DX1004 — type/bounds violation in a concrete flow conf
     (``pipeline.depth=0``, a negative TTL, an HBM budget above the
     chip).
   - DX1005 — incompatible-knob combination from the declared
     constraint table (mesh+sizedtransfer, mesh+backgroundtransfer,
     ``state.filteringest`` without state partitions).

The runtime half lives in ``runtime/confaudit.py`` (DX1006): the same
registry rows audit the LIVE conf at host/LQ-service init.

Like the race/protocol tiers, flow-level entry
(:func:`analyze_flow_conf`) reuses one mtime-cached scan of the real
tree and adds per-flow value/constraint checks for the flow's
designer knobs. ``python -m data_accelerator_tpu_torch.analysis.confcheck``
dumps the scanned inventory (read sites, produced keys, knob tokens)
as JSON — the registry in ``confspec.py`` is maintained against that
dump, and the tier-1 self-lint pins the counts so they cannot drift.

Copy of the JAX package's ``analysis/confcheck.py``, scanning the
port's own tree (``python -m data_accelerator_tpu_torch.analysis.
confcheck`` dumps it). The producer scan's generation half and the
registry-form DX1002 chain checks wait for the control plane: they run
only when ``serve/generation.py`` is in the scan set, and the port has
no such module until slice 9, so the full-tree gate judges read sites,
the flattener template (``compile/flattener_schema.py``, copied) and
the registry's read rows.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .diagnostics import (
    Diagnostic, REPORT_SCHEMA_VERSION, Span, make,
)
from .racecheck import _rel_path
from .confspec import (
    CONF_REGISTRY, CONSTRAINTS, ConfKey, PROCESS_PREFIX, check_conf_mapping,
    defaults_equal, check_value, match_key, registry_index,
    rows_matching_family,
)
from ..core.config import parse_conf_lines

# ---------------------------------------------------------------------------
# Scan scope
# ---------------------------------------------------------------------------
# every package that reads or produces process-namespace conf — wider
# than the race/proto engine surface because conf reads live in the
# observability, serving and compile planes too
CONF_PACKAGES = (
    "compile", "core", "dist", "lq", "native", "obs", "ops", "pilot",
    "runtime", "serve", "udf", "utils", "web",
)

_NS_CONSTS = {
    "JobPrefix": "datax.job.",
    "JobInputPrefix": "datax.job.input.",
    "JobProcessPrefix": "datax.job.process.",
    "JobOutputPrefix": "datax.job.output.",
}

# SettingDictionary getters (plus dict.get on conf mappings):
# name -> index of the literal-default argument, None = no default arg
_GETTERS: Dict[str, Optional[int]] = {
    "get": 1,
    "get_string": None,
    "get_or_else": 1,
    "get_int_option": None,
    "get_long": None,
    "get_long_option": None,
    "get_double": None,
    "get_double_option": None,
    "get_bool_option": None,
    "get_duration": None,
    "get_duration_option": None,
    "get_string_seq_option": None,
}

_MARKER_RE = re.compile(
    r"#\s*dx-conf:\s*read\s+(?P<key>[A-Za-z0-9_.*-]+)"
    r"(?:\s+default=(?P<default>\S+))?"
)
_TOKEN_RE = re.compile(r"^(gui)?[a-zA-Z][A-Za-z0-9]{1,40}$")
_GUI_TOKEN_RE = re.compile(r"^guiJob[A-Z]")
_KNOB_RE = re.compile(r"^job[A-Z]")


def conf_module_paths() -> List[str]:
    """Every .py file the standing conf gate scans."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: List[str] = []
    for pkg in CONF_PACKAGES:
        root = os.path.join(pkg_root, pkg)
        for dirpath, _dirs, files in os.walk(root):
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(out)


# ---------------------------------------------------------------------------
# Scan records
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ReadSite:
    """One runtime conf read. ``key`` is relative to the process
    namespace; a ``**`` tail marks a family walk (bulk read)."""

    key: str
    module: str
    line: int
    getter: str
    default: Optional[str] = None


@dataclass(frozen=True)
class ProducedKey:
    """One generated/control-plane conf key write. ``links`` carries
    the knob/token literals referenced by the producing statement —
    the designer-chain evidence DX1002 consumes."""

    key: str
    module: str
    line: int
    via: str  # subscript | dict | table | template
    links: Tuple[str, ...] = ()


@dataclass(frozen=True)
class KnobToken:
    """One S400 gui token: designer knob(s) in, generation default out."""

    token: str
    knobs: Tuple[str, ...]
    default: Optional[str]
    module: str
    line: int


def _canon_literal(node: ast.AST) -> Optional[str]:
    """Canonical string form of a literal default (bool -> true/false)."""
    if not isinstance(node, ast.Constant):
        return None
    v = node.value
    if v is None:
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


# ---------------------------------------------------------------------------
# Per-module scanner
# ---------------------------------------------------------------------------
class _ModuleConfScan:
    """Two-pass ordered AST scan of one module.

    Pass 1 resolves every name/attribute bound (possibly through
    chains) to a conf prefix string; pass 2 harvests read sites and
    produced keys using that symbol table. Unresolvable pieces become
    ``*`` (one segment) / ``**`` (rest) wildcards rather than being
    dropped, so dynamic families stay visible to the lattice.
    """

    def __init__(self, path: str):
        self.path = path
        self.rel = _rel_path(path)
        self.reads: List[ReadSite] = []
        self.produced: List[ProducedKey] = []
        self.tokens: List[KnobToken] = []
        self.knob_reads: Dict[str, int] = {}  # jobXxx literal -> line
        self.scope: Dict[str, Tuple[str, ...]] = {}
        self.paired: Dict[str, Tuple[int, Tuple[Tuple[str, ...], ...]]] = {}
        self.wrappers: Dict[str, Tuple[str, int, Optional[int]]] = {}
        self._seen_reads: set = set()
        self._seen_prod: set = set()

    # -- pass 1: symbol table ------------------------------------------
    def run(self) -> bool:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src)
        except (OSError, SyntaxError):
            return False
        self._bind_loops(tree)
        # iterate binding to a fixpoint: sub-dictionary chains assign
        # through intermediate names in arbitrary textual order
        for _ in range(4):
            before = dict(self.scope)
            for node in ast.walk(tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    self._bind(node.targets[0], node.value)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    self._bind(node.target, node.value)
            if self.scope == before:
                break
        self._find_wrappers(tree)
        self._harvest(tree.body, if_stack=[])
        self._harvest_markers(src)
        return True

    def _harvest_markers(self, src: str) -> None:
        """``# dx-conf: read <key> [default=<v>]`` markers: escape hatch
        for reads the AST scan cannot see (a conf sub-dictionary handed
        across a module boundary as a plain parameter — e.g. the
        ``debug.`` dict the host passes to ``sanitizer.from_conf``)."""
        for i, line in enumerate(src.splitlines(), start=1):
            m = _MARKER_RE.search(line)
            if not m:
                continue
            key = m.group("key")
            if not key.startswith(PROCESS_PREFIX):
                key = PROCESS_PREFIX + key
            self._emit_read(key, i, "marker", m.group("default"))

    def _bind_loops(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, ast.For):
                continue
            it = node.iter
            if not isinstance(it, (ast.Tuple, ast.List)):
                continue
            tgt = node.target
            if isinstance(tgt, ast.Name):
                vals = tuple(
                    str(e.value) for e in it.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                )
                if vals and len(vals) == len(it.elts):
                    self.scope[tgt.id] = vals
            elif isinstance(tgt, ast.Tuple) and all(
                isinstance(n, ast.Name) for n in tgt.elts
            ):
                rows = []
                for e in it.elts:
                    if not (
                        isinstance(e, ast.Tuple)
                        and len(e.elts) == len(tgt.elts)
                        and all(
                            isinstance(c, ast.Constant)
                            and isinstance(c.value, str)
                            for c in e.elts
                        )
                    ):
                        rows = []
                        break
                    rows.append(tuple(c.value for c in e.elts))
                if rows:
                    rows_t = tuple(rows)
                    for i, n in enumerate(tgt.elts):
                        self.scope[n.id] = tuple(r[i] for r in rows_t)
                        self.paired[n.id] = (i, rows_t)

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        name: Optional[str] = None
        if isinstance(target, ast.Name):
            name = target.id
        elif isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ) and target.value.id == "self":
            name = "self." + target.attr
        if name is None or name in self.paired:
            return
        vals = tuple(
            v for v in self._resolve(value)
            if v.startswith("datax.job.") or "*" in v
        )
        if vals:
            self.scope[name] = vals
        elif (
            isinstance(value, ast.Constant)
            and isinstance(value.value, str)
        ):
            # plain module/string constant: usable as prefix material
            self.scope.setdefault(name, (value.value,))

    def _resolve(self, node: ast.AST) -> Tuple[str, ...]:
        """Resolve an expression to candidate prefix/key strings.
        Unknown f-string holes become ``*`` segments."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return (node.value,)
        if isinstance(node, ast.Name):
            return self.scope.get(node.id, ())
        if isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "SettingNamespace"
                and node.attr in _NS_CONSTS
            ):
                return (_NS_CONSTS[node.attr],)
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return self.scope.get("self." + node.attr, ())
            return ()
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self._resolve(node.left)
            right = self._resolve(node.right)
            return tuple(l + r for l in left for r in right)
        if isinstance(node, ast.JoinedStr):
            parts: List[Tuple[str, ...]] = []
            for v in node.values:
                if isinstance(v, ast.Constant):
                    parts.append((str(v.value),))
                elif isinstance(v, ast.FormattedValue):
                    resolved = self._resolve(v.value)
                    parts.append(resolved if resolved else ("*",))
                else:
                    parts.append(("*",))
            out: Tuple[str, ...] = ("",)
            for p in parts:
                out = tuple(o + s for o in out for s in p)
                if len(out) > 32:  # defensive: cap combinatorics
                    return out[:32]
            return out
        if isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "get_sub_dictionary"
                and node.args
            ):
                args = self._resolve(node.args[0])
                base = self._resolve(fn.value)
                out = []
                for a in args:
                    if a.startswith("datax.job."):
                        out.append(a)
                    else:
                        out.extend(b + a for b in base)
                return tuple(out)
            if (
                isinstance(fn, ast.Name)
                and fn.id in ("str", "format")
                and node.args
            ):
                return self._resolve(node.args[0])
        return ()

    def _find_wrappers(self, tree: ast.AST) -> None:
        """Detect local conf-helper functions so their call sites count
        as read sites with the prefix baked in. Two shapes:
        module-level ``_conf_get(conf, key, default)`` concatenating a
        prefix constant with the key param, and closure helpers
        (``def f(key, default): v = sub.get(key)``) whose receiver is
        a conf-resolved name from the enclosing scope."""
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            params = [a.arg for a in node.args.args]
            d_idx = (
                params.index("default") if "default" in params
                else (1 if len(params) > 1 else None)
            )
            done = False
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.BinOp)
                    and isinstance(sub.op, ast.Add)
                    and isinstance(sub.left, ast.Name)
                    and isinstance(sub.right, ast.Name)
                    and sub.right.id in params
                ):
                    pref = tuple(
                        p for p in self.scope.get(sub.left.id, ())
                        if p.startswith(PROCESS_PREFIX)
                    )
                    if pref:
                        self.wrappers[node.name] = (
                            pref[0], params.index(sub.right.id), d_idx,
                        )
                        done = True
                        break
            if done:
                continue
            for sub in ast.walk(node):
                if not (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _GETTERS
                    and sub.args
                    and isinstance(sub.args[0], ast.Name)
                    and sub.args[0].id in params
                ):
                    continue
                pref = tuple(
                    p for p in self._resolve(sub.func.value)
                    if p.startswith(PROCESS_PREFIX)
                )
                if pref:
                    self.wrappers[node.name] = (
                        pref[0], params.index(sub.args[0].id), d_idx,
                    )
                    break

    # -- pass 2: harvest -----------------------------------------------
    _KEY_OK_RE = re.compile(r"^[A-Za-z0-9_.*-]+$")

    @classmethod
    def _sanitize(cls, key: str) -> Optional[str]:
        """Collapse partially-resolved segments to one ``*`` each and
        reject strings that cannot be conf keys (the module-union
        symbol table can mis-bind a reused name to metric/format
        strings — those never look like dotted conf keys)."""
        if not cls._KEY_OK_RE.match(key):
            return None
        segs = key.split(".")
        out = []
        for i, s in enumerate(segs):
            if s == "**" and i == len(segs) - 1:
                out.append(s)
            elif "*" in s:
                out.append("*")
            else:
                out.append(s)
        return ".".join(out)

    def _emit_read(
        self, key: str, line: int, getter: str, default: Optional[str],
    ) -> None:
        if not key.startswith(PROCESS_PREFIX):
            return
        rel = self._sanitize(key[len(PROCESS_PREFIX):])
        if not rel or rel == "**":
            return
        sig = (rel, line, getter)
        if sig in self._seen_reads:
            return
        self._seen_reads.add(sig)
        self.reads.append(ReadSite(rel, self.rel, line, getter, default))

    def _emit_prod(
        self, key: str, line: int, via: str, links: Sequence[str],
    ) -> None:
        if not key.startswith(PROCESS_PREFIX):
            return
        rel = self._sanitize(key[len(PROCESS_PREFIX):])
        if not rel:
            return
        sig = (rel, line)
        if sig in self._seen_prod:
            return
        self._seen_prod.add(sig)
        self.produced.append(
            ProducedKey(rel, self.rel, line, via, tuple(sorted(set(links))))
        )

    @staticmethod
    def _stmt_links(nodes: Sequence[ast.AST]) -> List[str]:
        out = []
        for root in nodes:
            for n in ast.walk(root):
                if (
                    isinstance(n, ast.Constant)
                    and isinstance(n.value, str)
                    and "." not in n.value
                    and _TOKEN_RE.match(n.value)
                ):
                    out.append(n.value)
        return out

    def _harvest(self, body: Sequence[ast.stmt], if_stack: List[ast.AST]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.If):
                self._harvest_exprs([stmt.test], if_stack)
                self._harvest(stmt.body, if_stack + [stmt.test])
                self._harvest(stmt.orelse, if_stack)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._harvest(stmt.body, [])
                continue
            if isinstance(stmt, ast.ClassDef):
                self._harvest(stmt.body, [])
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._harvest_exprs([stmt.iter], if_stack)
                self._harvest(stmt.body, if_stack)
                self._harvest(stmt.orelse, if_stack)
                continue
            if isinstance(stmt, ast.While):
                self._harvest_exprs([stmt.test], if_stack)
                self._harvest(stmt.body, if_stack)
                continue
            if isinstance(stmt, ast.Try):
                self._harvest(stmt.body, if_stack)
                for h in stmt.handlers:
                    self._harvest(h.body, if_stack)
                self._harvest(stmt.orelse, if_stack)
                self._harvest(stmt.finalbody, if_stack)
                continue
            if isinstance(stmt, ast.With):
                self._harvest_exprs(
                    [i.context_expr for i in stmt.items], if_stack
                )
                self._harvest(stmt.body, if_stack)
                continue
            # producer: subscript store  conf["datax.job.process…"] = v
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        self._harvest_subscript_store(t, stmt, if_stack)
            self._harvest_exprs([stmt], if_stack)

    def _harvest_subscript_store(
        self, target: ast.Subscript, stmt: ast.stmt, if_stack: List[ast.AST],
    ) -> None:
        sl = target.slice
        links = self._stmt_links([stmt] + list(if_stack))
        # paired-table f-string: one hole bound by a (knob, key) row
        if isinstance(sl, ast.JoinedStr):
            holes = [
                v.value.id for v in sl.values
                if isinstance(v, ast.FormattedValue)
                and isinstance(v.value, ast.Name)
            ]
            if len(holes) == 1 and holes[0] in self.paired:
                col, rows = self.paired[holes[0]]
                lit = "".join(
                    str(v.value) if isinstance(v, ast.Constant) else "\0"
                    for v in sl.values
                )
                for row in rows:
                    self._emit_prod(
                        lit.replace("\0", row[col]), target.lineno,
                        "table", links + [c for c in row if c != row[col]],
                    )
                return
        for key in self._resolve(sl):
            self._emit_prod(key, target.lineno, "subscript", links)

    def _harvest_exprs(
        self, roots: Sequence[ast.AST], if_stack: List[ast.AST],
    ) -> None:
        for root in roots:
            for node in ast.walk(root):
                if isinstance(node, ast.Call):
                    self._harvest_call(node, root, if_stack)
                elif isinstance(node, ast.Dict):
                    self._harvest_dict(node, if_stack)
                elif (
                    isinstance(node, ast.Attribute) and node.attr == "dict"
                ):
                    for p in self._resolve(node.value):
                        self._emit_read(
                            p + "**", node.lineno, ".dict", None,
                        )
                elif isinstance(node, ast.DictComp):
                    # producer: {f"datax.job.process…{k}": v for …}
                    for key in self._resolve(node.key):
                        self._emit_prod(key, node.lineno, "dict", ())

    def _harvest_dict(self, node: ast.Dict, if_stack: List[ast.AST]) -> None:
        for k, v in zip(node.keys, node.values):
            if k is None:
                continue
            # S400-style gui token rows: knob chain + generation default
            if (
                isinstance(k, ast.Constant)
                and isinstance(k.value, str)
                and _GUI_TOKEN_RE.match(k.value)
            ):
                knobs = tuple(
                    n.args[0].value for n in ast.walk(v)
                    if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "get"
                    and n.args
                    and isinstance(n.args[0], ast.Constant)
                    and isinstance(n.args[0].value, str)
                    and _KNOB_RE.match(n.args[0].value)
                )
                default: Optional[str] = None
                for b in ast.walk(v):
                    if isinstance(b, ast.BoolOp) and isinstance(
                        b.op, ast.Or
                    ):
                        default = _canon_literal(b.values[-1])
                if knobs:
                    self.tokens.append(KnobToken(
                        k.value, knobs, default, self.rel, k.lineno,
                    ))
            keys: Tuple[str, ...] = ()
            if isinstance(k, (ast.Constant, ast.JoinedStr, ast.BinOp)):
                keys = self._resolve(k)
            for key in keys:
                self._emit_prod(
                    key, k.lineno, "dict", self._stmt_links([v] + list(if_stack)),
                )

    def _harvest_call(
        self, node: ast.Call, stmt_root: ast.AST, if_stack: List[ast.AST],
    ) -> None:
        fn = node.func
        # local wrapper helper: _conf_get(conf, "key", default)
        if isinstance(fn, ast.Name) and fn.id in self.wrappers:
            prefix, k_idx, d_idx = self.wrappers[fn.id]
            if len(node.args) > k_idx and isinstance(
                node.args[k_idx], ast.Constant
            ):
                default = None
                if d_idx is not None and len(node.args) > d_idx:
                    default = _canon_literal(node.args[d_idx])
                self._emit_read(
                    prefix + str(node.args[k_idx].value),
                    node.lineno, fn.id, default,
                )
            return
        if not isinstance(fn, ast.Attribute):
            return
        if fn.attr == "group_by_sub_namespace":
            if node.args:  # prefix passed as argument
                for p in self._resolve(node.args[0]):
                    self._emit_read(p + "**", node.lineno, fn.attr, None)
            else:
                for p in self._resolve(fn.value):
                    self._emit_read(p + "**", node.lineno, fn.attr, None)
            return
        if fn.attr == "setdefault" and len(node.args) >= 1:
            # producer: conf.setdefault("datax.job.process…", default)
            for key in self._resolve(node.args[0]):
                self._emit_prod(
                    key, node.lineno, "subscript",
                    self._stmt_links(node.args[1:]),
                )
            return
        if fn.attr not in _GETTERS:
            return
        prefixes = tuple(
            p for p in self._resolve(fn.value)
            if p.startswith("datax.job.")
        )
        if not node.args:
            return
        key_arg = node.args[0]
        fulls: List[str] = []
        key_strs = (
            self._resolve(key_arg)
            if isinstance(key_arg, (ast.Constant, ast.JoinedStr, ast.BinOp,
                                    ast.Name, ast.Attribute))
            else ()
        )
        for ks in key_strs:
            if ks.startswith("datax.job."):
                fulls.append(ks)
            else:
                fulls.extend(p + ks for p in prefixes)
        if not key_strs and prefixes:
            fulls.extend(p + "**" for p in prefixes)
        # harvest the knob vocabulary for chain checks
        if (
            isinstance(key_arg, ast.Constant)
            and isinstance(key_arg.value, str)
            and _KNOB_RE.match(key_arg.value)
        ):
            self.knob_reads.setdefault(key_arg.value, node.lineno)
        d_idx = _GETTERS[fn.attr]
        default = None
        if d_idx is not None and len(node.args) > d_idx:
            default = _canon_literal(node.args[d_idx])
        for full in fulls:
            self._emit_read(full, node.lineno, fn.attr, default)


# ---------------------------------------------------------------------------
# Template (flattener-schema) producer enumeration
# ---------------------------------------------------------------------------
def template_produced_keys() -> List[str]:
    """Process-namespace keys the declarative flattener template can
    emit — derived from ``DEFAULT_FLATTENER_SCHEMA`` itself so the doc
    and the lattice can never drift from the flattener."""
    from ..compile.flattener_schema import DEFAULT_FLATTENER_SCHEMA

    process = DEFAULT_FLATTENER_SCHEMA["fields"]["process"]
    out: List[str] = []

    def walk(node, prefix: str) -> None:
        if isinstance(node, str):
            out.append(prefix + node)
            return
        t = node.get("type")
        ns = node.get("namespace", "")
        if t in ("object",):
            for _f, sub in node.get("fields", {}).items():
                walk(sub, prefix + ns + "." if ns else prefix)
        elif t in ("stringList", "excludeDefaultValue"):
            out.append(prefix + ns)
        elif t == "mapProps":
            out.append(prefix + ns + ".*")
        elif t == "map":
            for _f, sub in node.get("fields", {}).items():
                walk(sub, prefix + ns + ".*.")
        elif t in ("array",):
            walk(node.get("element", {}), prefix + ns + "." if ns else prefix)
        elif t == "scopedObject":
            base = prefix + (ns + "." if ns else "") + "*."
            for _f, sub in node.get("fields", {}).items():
                walk(sub, base)

    for _f, sub in process.get("fields", {}).items():
        walk(sub, "")
    return sorted(set(out))


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------
@dataclass
class ConfCheckReport:
    """Result of the configuration-lattice pass."""

    flow: str
    analyzed_files: int
    read_sites: List[ReadSite] = field(default_factory=list)
    produced: List[ProducedKey] = field(default_factory=list)
    tokens: List[KnobToken] = field(default_factory=list)
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def conf_dict(self) -> dict:
        return {
            "flow": self.flow,
            "analyzedFiles": self.analyzed_files,
            "readSites": len(self.read_sites),
            "readKeys": len({r.key for r in self.read_sites}),
            "producedKeys": len({p.key for p in self.produced}),
            "knobTokens": len(self.tokens),
            "registryKeys": len(CONF_REGISTRY),
            "constraints": len(CONSTRAINTS),
        }

    def to_dict(self) -> dict:
        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "flow": self.flow,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "conf": self.conf_dict(),
        }

    def render(self) -> str:
        lines = [
            f"conf: {len(self.read_sites)} read site(s), "
            f"{len({p.key for p in self.produced})} produced key(s), "
            f"{len(CONF_REGISTRY)} registered",
        ]
        lines.extend(d.render() for d in self.diagnostics)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def _derived_jt_name(token: str) -> str:
    """``guiJobNumChips`` -> ``jobNumChips`` (the flowbuilder jt hop)."""
    if token.startswith("gui") and len(token) > 4:
        return token[3].lower() + token[4:]
    return token


def _check_lattice(
    scans: List[_ModuleConfScan],
    diags: List[Diagnostic],
    full_tree: bool,
    chain_scope: bool,
) -> None:
    reads = [r for s in scans for r in s.reads]
    produced = [p for s in scans for p in s.produced]
    tokens = [t for s in scans for t in s.tokens]
    knob_reads: Dict[str, Tuple[str, int]] = {}
    for s in scans:
        for k, ln in s.knob_reads.items():
            knob_reads.setdefault(k, (s.rel, ln))

    # DX1000: read site with no lattice row behind it
    for r in reads:
        if "*" in r.key:
            if not rows_matching_family(r.key):
                diags.append(make(
                    "DX1000", r.module,
                    f"conf family '{PROCESS_PREFIX}{r.key}' is walked "
                    f"({r.getter}) but no registered key lives under it "
                    "— nothing can produce what this read consumes",
                    Span(line=r.line),
                ))
            continue
        entry = match_key(r.key)
        if entry is None:
            diags.append(make(
                "DX1000", r.module,
                f"conf key '{PROCESS_PREFIX}{r.key}' is read "
                f"({r.getter}) but is not in the conf registry — a "
                "dead knob or a typo'd key no generation path produces",
                Span(line=r.line),
            ))
        elif r.default is not None and not defaults_equal(entry, r.default):
            diags.append(make(
                "DX1003", r.module,
                f"default drift on '{PROCESS_PREFIX}{r.key}': this "
                f"read site falls back to {r.default!r} but the "
                f"registry default is {entry.default!r} — 'unset' "
                "means different things on different layers",
                Span(line=r.line),
            ))

    # DX1001: produced key with no lattice row behind it
    for p in produced:
        if "*" in p.key:
            if not rows_matching_family(
                p.key if p.key.endswith("*") else p.key
            ):
                diags.append(make(
                    "DX1001", p.module,
                    f"generated conf family '{PROCESS_PREFIX}{p.key}' "
                    f"({p.via}) matches no registered key — dead conf "
                    "no runtime reader will ever see",
                    Span(line=p.line),
                ))
            continue
        if match_key(p.key) is None:
            diags.append(make(
                "DX1001", p.module,
                f"generated conf key '{PROCESS_PREFIX}{p.key}' "
                f"({p.via}) is not in the conf registry — "
                "generated-but-never-read dead conf",
                Span(line=p.line),
            ))

    # DX1002 (local form): an S400 gui token no produced key carries
    prod_links = set()
    for p in produced:
        prod_links.update(p.links)
    for t in tokens:
        names = {t.token, _derived_jt_name(t.token)}
        if not (names & prod_links):
            diags.append(make(
                "DX1002", t.module,
                f"broken designer chain: gui token '{t.token}' (knob "
                f"{'/'.join(t.knobs)}) is built but no generated conf "
                "key carries it — the designer knob never reaches the "
                "runtime",
                Span(line=t.line),
            ))

    # DX1003 (generation form): S400 default vs registry default
    by_token = {e.token: e for e in CONF_REGISTRY if e.token}
    for t in tokens:
        entry = by_token.get(t.token)
        if (
            entry is not None
            and t.default not in (None, "")
            and entry.default is not None
            and not defaults_equal(entry, t.default)
        ):
            diags.append(make(
                "DX1003", t.module,
                f"default drift on '{PROCESS_PREFIX}{entry.key}': "
                f"generation token '{t.token}' defaults to "
                f"{t.default!r} but the registry default is "
                f"{entry.default!r}",
                Span(line=t.line),
            ))

    # DX1002 (registry form): declared knob→key chains must exist in
    # the scanned generation — only meaningful when the real
    # generation module is in the scan set
    if chain_scope:
        produced_exact = {p.key for p in produced if "*" not in p.key}
        produced_fams = {p.key for p in produced if "*" in p.key}
        tmpl = set(template_produced_keys())
        # a knob is "read by generation" when it appears as a direct
        # jobconf.get literal OR rides a produced row's links (the S640
        # paired-table rows read their knobs through the loop variable)
        knob_sites: Dict[str, Tuple[str, int]] = dict(knob_reads)
        for p in produced:
            for link in p.links:
                if _KNOB_RE.match(link):
                    knob_sites.setdefault(link, (p.module, p.line))
        for e in CONF_REGISTRY:
            if not e.knob:
                continue
            if e.knob not in knob_sites:
                diags.append(make(
                    "DX1002", "analysis/confspec.py",
                    f"broken designer chain: registry declares knob "
                    f"'{e.knob}' for '{PROCESS_PREFIX}{e.key}' but the "
                    "generation scan never reads that knob",
                ))
                continue
            if "*" in e.key:
                continue
            covered = (
                e.key in produced_exact
                or e.key in tmpl
                or any(
                    _fam_covers(f, e.key) for f in produced_fams
                )
            )
            if not covered:
                mod, ln = knob_sites[e.knob]
                diags.append(make(
                    "DX1002", mod,
                    f"broken designer chain: knob '{e.knob}' is read "
                    f"by generation but its registered key "
                    f"'{PROCESS_PREFIX}{e.key}' is never written — "
                    "the knob's value is dropped on the floor",
                    Span(line=ln),
                ))

    # DX1001 (registry form, full-tree self-lint only): a read=True
    # row no scanned module reads — stale registry / dead conf
    if full_tree:
        read_exact = {r.key for r in reads if "*" not in r.key}
        read_fams = [r.key for r in reads if "*" in r.key]
        for e in CONF_REGISTRY:
            if not e.read:
                continue
            covered = (
                e.key in read_exact
                or any(_fam_covers(f, e.key) for f in read_fams)
            )
            if not covered and "*" in e.key:
                covered = any(
                    _fam_covers(e.key, rk) for rk in read_exact
                )
            if not covered:
                diags.append(make(
                    "DX1001", "analysis/confspec.py",
                    f"registry row '{PROCESS_PREFIX}{e.key}' is marked "
                    "read=True but no scanned module reads it — dead "
                    "conf (mark read=False if it is a parity key, or "
                    "delete the production)",
                ))


def _fam_covers(family: str, key: str) -> bool:
    from .confspec import _family_covers

    return _family_covers(family, key)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def analyze_conf_modules(
    paths: List[str], flow: str = "",
) -> ConfCheckReport:
    """Run the DX10xx pass over explicit files — ``.py`` modules are
    scanned for read/producer sites; ``.conf`` files are parsed and
    value-checked (DX1004/DX1005) against the lattice."""
    scans: List[_ModuleConfScan] = []
    diags: List[Diagnostic] = []
    analyzed = 0
    conf_files: List[str] = []
    for p in paths:
        if p.endswith(".conf"):
            conf_files.append(p)
            continue
        s = _ModuleConfScan(p)
        if s.run():
            scans.append(s)
            analyzed += 1
    real = set(conf_module_paths())
    full_tree = real and real.issubset(set(paths))
    chain_scope = any(
        os.path.basename(p) == "generation.py" for p in paths
    )
    _check_lattice(scans, diags, full_tree, chain_scope)
    for cf in conf_files:
        analyzed += 1
        rel = _rel_path(cf)
        try:
            with open(cf, "r", encoding="utf-8") as f:
                mapping = parse_conf_lines(f.read().splitlines())
        except OSError as e:
            diags.append(make(
                "DX1004", rel, f"cannot read conf file: {e}",
            ))
            continue
        for kind, key, reason in check_conf_mapping(mapping):
            if kind == "value":
                diags.append(make(
                    "DX1004", rel,
                    f"conf value violation on "
                    f"'{PROCESS_PREFIX}{key}': {reason}",
                ))
            elif kind == "constraint":
                diags.append(make(
                    "DX1005", rel,
                    f"incompatible conf combination ({key}): {reason}",
                ))
            else:  # unknown key in a concrete conf = dead conf
                diags.append(make(
                    "DX1001", rel,
                    f"conf file carries '{PROCESS_PREFIX}{key}' but "
                    f"no registry row covers it — {reason}",
                ))
    return ConfCheckReport(
        flow=flow,
        analyzed_files=analyzed,
        read_sites=[r for s in scans for r in s.reads],
        produced=[p for s in scans for p in s.produced],
        tokens=[t for s in scans for t in s.tokens],
        diagnostics=diags,
    )


# mtime-keyed cache of the full-tree scan (the expensive part of
# analyze_flow_conf; the per-flow checks are cheap dict work)
_ENGINE_CACHE: Dict[tuple, ConfCheckReport] = {}


def _cached_tree_report() -> ConfCheckReport:
    paths = conf_module_paths()
    key = tuple((p, os.path.getmtime(p)) for p in paths)
    hit = _ENGINE_CACHE.get(key)
    if hit is None:
        _ENGINE_CACHE.clear()
        hit = analyze_conf_modules(paths)
        _ENGINE_CACHE[key] = hit
    return hit


def effective_flow_conf(flow: Mapping) -> Dict[str, str]:
    """The flow's designer-visible effective conf (relative keys):
    registry defaults overlaid with the flow's ``jobconfig`` knob
    values mapped through their registered chains."""
    gui = flow.get("gui") or flow
    jobconf = ((gui.get("process") or {}).get("jobconfig") or {})
    eff: Dict[str, str] = {
        e.key: e.default for e in CONF_REGISTRY
        if e.default is not None and "*" not in e.key
    }
    for e in CONF_REGISTRY:
        if not e.knob or "*" in e.key:
            continue
        v = jobconf.get(e.knob)
        if v not in (None, ""):
            eff[e.key] = str(v)
    return eff


def analyze_flow_conf(flow: Mapping) -> ConfCheckReport:
    """Flow-level conf gate: the cached full-tree lattice scan plus
    this flow's concrete knob values checked for type/bounds (DX1004)
    and incompatible combinations (DX1005)."""
    gui = flow.get("gui") or flow
    name = str(flow.get("name") or gui.get("name") or "")
    base = _cached_tree_report()
    diags = list(base.diagnostics)
    jobconf = ((gui.get("process") or {}).get("jobconfig") or {})
    by_knob = {e.knob: e for e in CONF_REGISTRY if e.knob}
    for knob, v in sorted(jobconf.items()):
        e = by_knob.get(knob)
        if e is None or v in (None, ""):
            continue
        reason = check_value(e, str(v))
        if reason:
            diags.append(make(
                "DX1004", name,
                f"designer knob '{knob}' "
                f"('{PROCESS_PREFIX}{e.key}'): {reason}",
            ))
    eff = effective_flow_conf(flow)
    for rule in CONSTRAINTS:
        if rule.violated(eff):
            diags.append(make(
                "DX1005", name,
                f"incompatible conf combination ({rule.name}): "
                f"{rule.description}",
            ))
    return ConfCheckReport(
        flow=name,
        analyzed_files=base.analyzed_files,
        read_sites=base.read_sites,
        produced=base.produced,
        tokens=base.tokens,
        diagnostics=diags,
    )


# ---------------------------------------------------------------------------
# Inventory dump (registry maintenance aid)
# ---------------------------------------------------------------------------
def inventory() -> dict:
    """The scanned lattice as JSON-able data — what the registry in
    ``confspec.py`` is maintained against."""
    rep = analyze_conf_modules(conf_module_paths())
    return {
        "readSites": [
            {
                "key": r.key, "module": r.module, "line": r.line,
                "getter": r.getter, "default": r.default,
            }
            for r in sorted(rep.read_sites, key=lambda r: (r.key, r.module, r.line))
        ],
        "produced": [
            {
                "key": p.key, "module": p.module, "line": p.line,
                "via": p.via, "links": list(p.links),
            }
            for p in sorted(rep.produced, key=lambda p: (p.key, p.module, p.line))
        ],
        "templateKeys": template_produced_keys(),
        "tokens": [
            {
                "token": t.token, "knobs": list(t.knobs),
                "default": t.default, "module": t.module, "line": t.line,
            }
            for t in sorted(rep.tokens, key=lambda t: t.token)
        ],
        "registered": sorted(e.key for e in CONF_REGISTRY),
        "findings": [d.render() for d in rep.diagnostics],
    }


if __name__ == "__main__":  # pragma: no cover — maintenance utility
    print(json.dumps(inventory(), indent=1))
