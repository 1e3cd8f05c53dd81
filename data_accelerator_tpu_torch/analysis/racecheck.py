"""Buffer-lifetime & concurrency analysis over the ENGINE'S OWN modules
(the ``--race`` tier, DX8xx).

Three separate changes each found and fixed a latent
use-after-free with the same root cause: donated/pooled 64-byte-aligned
buffers are ZERO-COPIED by the CPU backend's ``jnp.asarray``/
``np.asarray``, and a view escaping its guarded scope is read from a
background thread after the next dispatch donated the memory — heap
corruption, not just stale data. This pass turns the hand-written
``copy=True`` comments standing between the codebase and the next such
bug into a standing CI gate, in the style of ThreadSanitizer's
lockset discipline and the taint walk ``udfcheck.py`` runs over UDF
ASTs — except the analyzed ASTs are ``runtime/``, ``lq/`` and
``pilot/`` themselves.

Buffer provenance lattice
-------------------------
Every expression carries one of four provenances:

- ``ring``  — a window ring buffer (``self.window_buffers`` and its
  ``cols``/``valid`` members): the step's DONATED argument
  (``STEP_DONATE_ARGNUMS``); freed by XLA at the next dispatch;
- ``pool``  — a ``PackedBufferPool`` ingest slot
  (``pool.acquire()`` results, ``_ingest_pool``/``_ingest_pools``/
  ``_ingest_buffers``): reused for the next decode once its batch
  lands;
- ``slot``  — an A/B output transfer slot (``self._slots``): donated
  into the next ``_pack_slot`` once the previous batch's land ack
  fires;
- plain — everything else.

Provenance flows through assignments, attribute/subscript loads,
``.items()/.values()/.get()`` traversal, container displays and
comprehensions. A REAL copy clears it: ``np.array(x, copy=True)``
(or default-copying ``np.array(x)``), ``jnp.array(x, copy=True)``,
``x.copy()``, ``np.copy(x)``, ``copy.deepcopy``. ``np.asarray``/
``jnp.asarray`` does NOT — that is the zero-copy view the whole bug
class rides on.

The checks
----------
- **DX800** — a ``ring``/``pool``/``slot`` value escapes its guarded
  scope: returned, stored into an attribute, stored into a container
  that is itself attribute-reachable or returned, or handed to another
  thread (``executor.submit``/``Thread(...)``) — without a real copy.
  The canonical instance is ``snapshot_window_state`` without
  ``copy=True``.
- **DX801** — ``np.asarray``/``jnp.asarray`` of a provenanced buffer
  outside an annotated allowed-zero-copy site.
- **DX802** — lockset discipline: an attribute written under
  ``with self.<lock>`` in one method and written WITHOUT that lock in
  another (``__init__`` and marked single-threaded paths exempt),
  plus conflicting lock-acquisition orders within a class.
- **DX803** — slot re-donated before its land ack: a ``_pack_slot``
  donation whose argument has ``slot`` provenance is not dominated by
  an ``is_set()``/``wait()`` land-ack check in the same function.
- **DX804** — blocking device sync (``block_until_ready``/
  ``device_get``/blocking waits) inside a function the pipeline model
  requires non-blocking (marked ``# dx-race: non-blocking``).

Marker contract (structured comments the analyzer reads from source)
--------------------------------------------------------------------
Line-scoped (same line as the site, or the line directly above):

- ``# dx-race: allow-zero-copy <reason>`` — pins a legitimate
  zero-copy ``asarray`` site (DX801); counted and reported, so the
  self-lint keeps an inventory of every place the engine relies on
  aliasing on purpose.
- ``# dx-race: owner-handoff <reason>`` — pins a DESIGNED ownership
  transfer (DX800): e.g. dispatch handing pooled ingest matrices to
  the ``PendingBatch`` that will release them at landing.

Function-scoped (any line inside the function):

- ``# dx-race: param <name>=<ring|pool|slot>`` — seeds a parameter's
  provenance (inter-procedural edge the walk cannot see).
- ``# dx-race: single-threaded <reason>`` — exempts a provably
  pre-thread/re-init path from the DX802 lockset rule.
- ``# dx-race: non-blocking`` — declares the function dispatch-path
  non-blocking, arming DX804 inside it.

The runtime counterpart is ``runtime/sanitizer.py`` (conf
``datax.job.process.debug.buffersanitizer``): poisons released pool
slots with a sentinel, alias-scans window snapshots against the live
rings, scans landed sink payloads for sentinel leakage, and fires
runtime **DX805** events into the flight recorder — the dynamic
ground truth the DX80x fixtures and the seeded snapshot regression test
are proven against.

Copy of the JAX package's ``analysis/racecheck.py``, with PyTorch's
aliasing and blocking forms:

- DX801 also flags the torch zero-copy forms of a provenanced buffer:
  ``torch.from_numpy(x)``, ``torch.as_tensor(x)``,
  ``torch.asarray(x)``, ``torch.frombuffer(x)``, and ``x.numpy()``
  (a CPU tensor's storage as an array). ``jnp`` is gone from the array
  modules; ``x.clone()`` is a real copy, as ``x.copy()`` is.
- DX804's blocking calls add ``synchronize`` (a stream, an event or
  ``torch.cuda``), ``x.cpu()``, and ``x.to(...)`` without
  ``non_blocking=True``.
- The gate's subject is the port's own ``runtime/``, ``lq/`` and
  ``pilot/``; its seed attributes are the reference's, since the port
  keeps ``window_buffers``, ``_ingest_pools`` and ``_slots``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, Span, make

# provenance values
RING = "ring"
POOL = "pool"
SLOT = "slot"

# attribute names that SEED provenance when loaded (the runtime's own
# ownership roots; see the module docstring's lattice)
SEED_ATTRS = {
    "window_buffers": RING,
    "_ingest_pools": POOL,
    "_ingest_pool": POOL,
    "_ingest_buffers": POOL,
    "_slots": SLOT,
}

# attribute accesses that traverse INTO a provenanced object without
# laundering it (a member of a ring is still the ring's memory)
_TRAVERSE_CALLS = {"items", "values", "get", "setdefault", "pop"}

# calls that are blocking device syncs / blocking waits (DX804 inside a
# non-blocking-marked function)
_BLOCKING_ATTRS = {
    "block_until_ready", "device_get", "item", "tolist",
    "wait", "result", "join", "sleep", "synchronize", "cpu",
}

_NUMPY_NAMES = {"np", "numpy"}

# torch functions that alias their argument's memory when they can (a
# numpy array or a tensor of the right dtype and device)
_TORCH_ZERO_COPY = {"from_numpy", "as_tensor", "asarray", "frombuffer"}

_MARKER_RE = re.compile(r"#\s*dx-race:\s*([a-z-]+)\s*(.*)$")
_PARAM_RE = re.compile(r"^(\w+)\s*=\s*(ring|pool|slot)\s*$")


@dataclass
class _Markers:
    """dx-race markers harvested from one module's raw source lines."""

    # 1-based line -> set of line-scoped marker kinds on/above it
    by_line: Dict[int, Set[str]] = field(default_factory=dict)
    # 1-based line -> {param name -> provenance}
    params: Dict[int, Dict[str, str]] = field(default_factory=dict)

    def line_has(self, line: int, kind: str) -> bool:
        return kind in self.by_line.get(line, ())


def _collect_markers(
    lines: List[str], tree: Optional[ast.AST] = None,
    marker_re: "re.Pattern" = _MARKER_RE,
) -> _Markers:
    m = _Markers()
    # statement spans let a marker above a multi-line statement cover
    # every line the statement occupies (the asarray may sit two lines
    # into a wrapped call)
    spans: Dict[int, int] = {}
    if tree is not None:
        for node in ast.walk(tree):
            if isinstance(node, ast.stmt):
                spans.setdefault(
                    node.lineno, getattr(node, "end_lineno", node.lineno)
                )
    for i, text in enumerate(lines, start=1):
        match = marker_re.search(text)
        if not match:
            continue
        kind, rest = match.group(1), match.group(2).strip()
        if kind == "param":
            pm = _PARAM_RE.match(rest)
            if pm:
                m.params.setdefault(i, {})[pm.group(1)] = pm.group(2)
            continue
        # a marker names its own line, then flows forward through any
        # continuation comment/blank lines onto the next statement —
        # covering that statement's FULL span, so a marker sentence may
        # wrap and the annotated call may too
        m.by_line.setdefault(i, set()).add(kind)
        j = i + 1
        while j <= len(lines) and (
            not lines[j - 1].strip()
            or lines[j - 1].lstrip().startswith("#")
        ):
            m.by_line.setdefault(j, set()).add(kind)
            j += 1
        for covered in range(j, spans.get(j, j) + 1):
            m.by_line.setdefault(covered, set()).add(kind)
    return m


def _fn_markers(markers: _Markers, node: ast.AST) -> Set[str]:
    """Function-scoped marker kinds present anywhere inside ``node``."""
    out: Set[str] = set()
    end = getattr(node, "end_lineno", node.lineno)
    for line, kinds in markers.by_line.items():
        if node.lineno <= line <= end:
            out |= kinds
    return out


def _fn_param_seeds(markers: _Markers, node: ast.AST) -> Dict[str, str]:
    out: Dict[str, str] = {}
    end = getattr(node, "end_lineno", node.lineno)
    for line, params in markers.params.items():
        if node.lineno <= line <= end:
            out.update(params)
    return out


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for nested attributes, '' when not a plain dotted name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    return name.endswith("Lock") or name.endswith("RLock") \
        or name.endswith("Condition") or name.endswith("Semaphore")


@dataclass
class _ClassState:
    """Per-class lockset bookkeeping (DX802)."""

    name: str
    lock_attrs: Set[str] = field(default_factory=set)
    # attr -> set of lock attr names it was written under
    locked_writes: Dict[str, Set[str]] = field(default_factory=dict)
    # (method, attr, line) writes outside any lock
    unlocked_writes: List[Tuple[str, str, int]] = field(default_factory=list)
    # observed nested acquisition orders: (outer, inner) -> line
    lock_orders: Dict[Tuple[str, str], int] = field(default_factory=dict)


class _FnRace:
    """Provenance walk over one function/method body."""

    def __init__(self, linter: "_ModuleLinter", node, cls: Optional[_ClassState],
                 method_name: str, seeds: Dict[str, str],
                 fn_marks: Set[str], locks_held: Tuple[str, ...] = ()):
        self.l = linter
        self.node = node
        self.cls = cls
        self.method = method_name
        self.prov: Dict[str, str] = dict(seeds)
        self.marks = fn_marks
        self.non_blocking = "non-blocking" in fn_marks
        self.single_threaded = "single-threaded" in fn_marks
        self.land_ack_seen = False
        self.locks_held: Tuple[str, ...] = locks_held

    # -- provenance of an expression (also performs call-site checks) --
    def _prov(self, node: Optional[ast.AST]) -> Optional[str]:
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return self.prov.get(node.id)
        if isinstance(node, ast.Attribute):
            seeded = SEED_ATTRS.get(node.attr)
            if seeded is not None:
                return seeded
            return self._prov(node.value)
        if isinstance(node, ast.Subscript):
            self._prov(node.slice)
            return self._prov(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            provs = [self._prov(e) for e in node.elts]
            return next((p for p in provs if p), None)
        if isinstance(node, ast.Dict):
            provs = [self._prov(v) for v in node.values]
            provs += [self._prov(k) for k in node.keys if k is not None]
            return next((p for p in provs if p), None)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            saved = dict(self.prov)
            for gen in node.generators:
                self._bind_loop_target(gen.target, gen.iter)
                for cond in gen.ifs:
                    self._prov(cond)
            p = self._prov(node.elt)
            self.prov = saved
            return p
        if isinstance(node, ast.DictComp):
            saved = dict(self.prov)
            for gen in node.generators:
                self._bind_loop_target(gen.target, gen.iter)
                for cond in gen.ifs:
                    self._prov(cond)
            p = self._prov(node.value) or self._prov(node.key)
            self.prov = saved
            return p
        if isinstance(node, ast.IfExp):
            self._prov(node.test)
            return self._prov(node.body) or self._prov(node.orelse)
        if isinstance(node, ast.BoolOp):
            provs = [self._prov(v) for v in node.values]
            return next((p for p in provs if p), None)
        if isinstance(node, ast.Starred):
            return self._prov(node.value)
        if isinstance(node, ast.NamedExpr):
            p = self._prov(node.value)
            if isinstance(node.target, ast.Name):
                self.prov[node.target.id] = p
            return p
        if isinstance(node, ast.Await):
            return self._prov(node.value)
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.Compare)):
            # arithmetic materializes a NEW array — provenance cleared,
            # but still walk for call side-effects
            for child in ast.iter_child_nodes(node):
                self._prov(child)
            return None
        if isinstance(node, ast.JoinedStr):
            return None
        # constants, lambdas, etc.
        return None

    def _call(self, node: ast.Call) -> Optional[str]:
        func = node.func
        # walk args for side-effects first (nested calls, land acks)
        arg_provs = [self._prov(a) for a in node.args]
        kw_provs = {
            (kw.arg or "**"): self._prov(kw.value) for kw in node.keywords
        }

        if isinstance(func, ast.Attribute):
            base, attr = func.value, func.attr
            base_name = _dotted(base)

            if attr in ("is_set", "wait") :
                self.land_ack_seen = True
            if attr in _BLOCKING_ATTRS:
                self._check_blocking(node, attr)
            if attr == "to" and not any(
                kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in node.keywords
            ):
                self._check_blocking(node, attr)
            if (attr == "asarray" and base_name in _NUMPY_NAMES) or (
                attr in _TORCH_ZERO_COPY and base_name == "torch"
            ):
                p = arg_provs[0] if arg_provs else None
                self._zero_copy(node, f"{base_name}.{attr}", p)
                return p
            if attr == "numpy" and not node.args:
                p = self._prov(base)
                self._zero_copy(node, "Tensor.numpy", p)
                return p
            if attr == "clone" and not node.args:
                return None  # x.clone() is a real copy
            if attr == "array" and base_name in _NUMPY_NAMES:
                cp = kw_provs  # walked above; now inspect the literal
                for kw in node.keywords:
                    if kw.arg == "copy" and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is False:
                        return arg_provs[0] if arg_provs else None
                return None  # np.array/jnp.array default-copies
            if attr == "copy" and not node.args:
                return None  # x.copy() is a real copy
            if attr in _TRAVERSE_CALLS:
                return self._prov(base)
            if attr == "keys":
                self._prov(base)
                return None
            if attr == "acquire" and "pool" in base_name.lower():
                return POOL
            if attr.endswith("_pack_slot"):
                self._check_donation(node, arg_provs)
                return None
            if attr == "submit" or attr == "apply_async":
                self._check_thread_handoff(node, arg_provs, kw_provs)
                return None
        elif isinstance(func, ast.Name):
            name = func.id
            if name in ("deepcopy",):
                return None
            if name == "Thread" or name.endswith("Thread"):
                self._check_thread_handoff(node, arg_provs, kw_provs)
                return None
        fname = _dotted(func)
        if fname.endswith("copy.deepcopy") or fname.endswith("np.copy"):
            return None
        if fname.endswith("Thread"):
            self._check_thread_handoff(node, arg_provs, kw_provs)
            return None
        if fname.endswith("block_until_ready") or fname.endswith("device_get"):
            self._check_blocking(node, fname.rsplit(".", 1)[-1])
        return None

    def _zero_copy(self, node: ast.Call, what: str, p: Optional[str]) -> None:
        """DX801 for an aliasing view of a provenanced buffer, unless the
        site is marked ``allow-zero-copy`` (then it is counted)."""
        if p is None:
            return
        if self.l.allowed_zero_copy(node.lineno):
            self.l.allowed_sites += 1
        else:
            self.l.emit(
                "DX801", node.lineno,
                f"zero-copy {what} of a {p} buffer in {self._where()}",
            )

    def _where(self) -> str:
        return (
            f"{self.cls.name}.{self.method}" if self.cls else self.method
        )

    def _check_blocking(self, node: ast.Call, what: str) -> None:
        if not self.non_blocking:
            return
        self.l.emit(
            "DX804", node.lineno,
            f"blocking call {what}() inside non-blocking "
            f"{self._where()} (dispatch-path contract)",
        )

    def _check_donation(self, node: ast.Call, arg_provs) -> None:
        if SLOT not in [p for p in arg_provs if p]:
            return
        if self.land_ack_seen:
            return
        self.l.emit(
            "DX803", node.lineno,
            f"slot buffer donated in {self._where()} without a "
            f"preceding land-ack check (is_set()/wait() on the "
            f"previous batch's landed event)",
        )

    def _check_thread_handoff(self, node: ast.Call, arg_provs, kw_provs) -> None:
        carried = [p for p in arg_provs if p] + [
            p for p in kw_provs.values() if p
        ]
        if not carried:
            return
        if self.l.line_marked(node.lineno, "owner-handoff"):
            self.l.handoff_sites += 1
            return
        self.l.emit(
            "DX800", node.lineno,
            f"{carried[0]} buffer handed to another thread from "
            f"{self._where()} without a real copy",
        )

    # -- loop/comprehension target binding -----------------------------
    def _bind_loop_target(self, target: ast.AST, iter_node: ast.AST) -> None:
        p = self._prov(iter_node)
        items_iter = (
            isinstance(iter_node, ast.Call)
            and isinstance(iter_node.func, ast.Attribute)
            and iter_node.func.attr == "items"
        )
        keys_iter = (
            isinstance(iter_node, ast.Call)
            and isinstance(iter_node.func, ast.Attribute)
            and iter_node.func.attr == "keys"
        )
        if isinstance(target, ast.Tuple) and items_iter \
                and len(target.elts) == 2:
            # dict .items(): the KEY does not alias the buffer, the
            # value does — taint only the value half
            k, v = target.elts
            if isinstance(k, ast.Name):
                self.prov.pop(k.id, None)
            self._bind(v, p)
            return
        if keys_iter:
            p = None
        self._bind(target, p)

    def _bind(self, target: ast.AST, p: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            if p is None:
                self.prov.pop(target.id, None)
            else:
                self.prov[target.id] = p
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, p)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, p)

    # -- statements ----------------------------------------------------
    def run(self) -> None:
        self._stmts(self.node.body)
        if self.cls is not None and self.locks_held == ():
            pass  # class bookkeeping happens inline during the walk

    def _stmts(self, body: List[ast.stmt]) -> None:
        for st in body:
            self._stmt(st)

    def _record_attr_write(self, attr: str, line: int,
                           value: Optional[ast.AST]) -> None:
        """Class lockset bookkeeping for a ``self.X = ...`` write."""
        if self.cls is None:
            return
        if value is not None and _is_lock_ctor(value):
            self.cls.lock_attrs.add(attr)
            return
        if self.method in ("__init__", "__new__") or self.single_threaded:
            return
        if self.method.endswith("_locked"):
            # the ``_locked`` suffix is the codebase's caller-holds-the-
            # lock idiom: the write IS lock-associated, acquired upstack
            self.cls.locked_writes.setdefault(attr, set()).add(
                "(caller-held)"
            )
            return
        if self.locks_held:
            self.cls.locked_writes.setdefault(attr, set()).update(
                self.locks_held
            )
        else:
            self.cls.unlocked_writes.append((self.method, attr, line))

    def _escape_check(self, target: ast.AST, p: Optional[str],
                      line: int) -> None:
        if p is None:
            return
        if isinstance(target, ast.Attribute):
            if self.l.line_marked(line, "owner-handoff"):
                self.l.handoff_sites += 1
                return
            self.l.emit(
                "DX800", line,
                f"{p} buffer stored into attribute "
                f"{_dotted(target) or target.attr} in {self._where()} "
                f"without a real copy",
            )
        elif isinstance(target, ast.Subscript):
            root = target.value
            while isinstance(root, ast.Subscript):
                root = root.value
            if isinstance(root, ast.Attribute):
                if self.l.line_marked(line, "owner-handoff"):
                    self.l.handoff_sites += 1
                    return
                self.l.emit(
                    "DX800", line,
                    f"{p} buffer stored into {_dotted(root)}[...] in "
                    f"{self._where()} without a real copy",
                )
            elif isinstance(root, ast.Name):
                # container stays local; taint it so a later
                # return/store of the container is caught
                self.prov[root.id] = p

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, ast.Assign):
            p = self._prov(st.value)
            for target in st.targets:
                if isinstance(target, ast.Name):
                    self._bind(target, p)
                elif isinstance(target, (ast.Tuple, ast.List)):
                    if isinstance(st.value, ast.Tuple) and \
                            len(st.value.elts) == len(target.elts):
                        for t, v in zip(target.elts, st.value.elts):
                            vp = self._prov(v)
                            if isinstance(t, ast.Name):
                                self._bind(t, vp)
                            else:
                                self._escape_check(t, vp, st.lineno)
                                if isinstance(t, ast.Attribute):
                                    self._record_attr_write(
                                        t.attr, st.lineno, v
                                    )
                    else:
                        self._bind(target, p)
                else:
                    self._escape_check(target, p, st.lineno)
                    if isinstance(target, ast.Attribute):
                        self._record_attr_write(target.attr, st.lineno,
                                                st.value)
                    elif isinstance(target, ast.Subscript):
                        root = target.value
                        while isinstance(root, ast.Subscript):
                            root = root.value
                        if isinstance(root, ast.Attribute):
                            self._record_attr_write(root.attr, st.lineno,
                                                    None)
        elif isinstance(st, ast.AnnAssign):
            p = self._prov(st.value) if st.value else None
            if isinstance(st.target, ast.Name):
                self._bind(st.target, p)
            else:
                self._escape_check(st.target, p, st.lineno)
                if isinstance(st.target, ast.Attribute):
                    self._record_attr_write(st.target.attr, st.lineno,
                                            st.value)
        elif isinstance(st, ast.AugAssign):
            self._prov(st.value)
            if isinstance(st.target, ast.Attribute):
                self._record_attr_write(st.target.attr, st.lineno, None)
        elif isinstance(st, ast.Return):
            p = self._prov(st.value)
            if p is not None:
                if self.l.line_marked(st.lineno, "owner-handoff"):
                    self.l.handoff_sites += 1
                else:
                    self.l.emit(
                        "DX800", st.lineno,
                        f"{p} buffer escapes via return from "
                        f"{self._where()} without a real copy",
                    )
        elif isinstance(st, ast.Expr):
            self._prov(st.value)
        elif isinstance(st, ast.If):
            self._prov(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._bind_loop_target(st.target, st.iter)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, ast.While):
            self._prov(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            entered: List[str] = []
            for item in st.items:
                lock = self._lock_name(item.context_expr)
                if lock is not None:
                    if self.cls is not None:
                        for held in self.locks_held:
                            self.cls.lock_orders.setdefault(
                                (held, lock), st.lineno
                            )
                    entered.append(lock)
                else:
                    self._prov(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, None)
            saved = self.locks_held
            self.locks_held = saved + tuple(entered)
            self._stmts(st.body)
            self.locks_held = saved
        elif isinstance(st, ast.Try):
            self._stmts(st.body)
            for h in st.handlers:
                self._stmts(h.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function (thread bodies, wrappers): analyze with a
            # copy of the enclosing environment — closures see it
            nested = _FnRace(
                self.l, st, self.cls, f"{self.method}.{st.name}",
                dict(self.prov), _fn_markers(self.l.markers, st)
                | (self.marks & {"single-threaded"}),
                locks_held=(),
            )
            nested.run()
        elif isinstance(st, (ast.Delete, ast.Assert)):
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._prov(child)
        # Pass/Break/Continue/Import/Global/Nonlocal/Raise: no flow

    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        """``self.<attr>`` where attr is (or looks like) a lock."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            attr = expr.attr
            if self.cls is not None and attr in self.cls.lock_attrs:
                return attr
            if attr.endswith("lock") or attr.endswith("_lock"):
                if self.cls is not None:
                    self.cls.lock_attrs.add(attr)
                return attr
        return None


class _ModuleLinter:
    """One engine module: parse, walk every class/function, emit."""

    def __init__(self, path: str, rel: str, src: str):
        self.path = path
        self.rel = rel
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.markers = _collect_markers(self.lines, self.tree)
        self.diags: List[Diagnostic] = []
        self._seen: Set[Tuple[str, int]] = set()
        self.allowed_sites = 0
        self.handoff_sites = 0
        self.functions = 0

    def line_marked(self, line: int, kind: str) -> bool:
        return self.markers.line_has(line, kind)

    def allowed_zero_copy(self, line: int) -> bool:
        return self.markers.line_has(line, "allow-zero-copy")

    def emit(self, code: str, line: int, message: str) -> None:
        key = (code, line)
        if key in self._seen:
            return
        self._seen.add(key)
        self.diags.append(
            make(code, self.rel, message, Span(line=line))
        )

    def run(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self._class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(node, cls=None)

    def _function(self, node, cls: Optional[_ClassState]) -> None:
        self.functions += 1
        seeds = _fn_param_seeds(self.markers, node)
        fn = _FnRace(
            self, node, cls, node.name, seeds,
            _fn_markers(self.markers, node),
        )
        fn.run()

    def _class(self, node: ast.ClassDef) -> None:
        cls = _ClassState(name=node.name)
        # pre-pass: find lock attributes (assigned threading.Lock() etc.
        # anywhere in the class) so `with self.<lock>` is recognized in
        # methods that appear before the assignment
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                for t in sub.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        cls.lock_attrs.add(t.attr)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(item, cls=cls)
        # DX802 resolution: attrs written under a lock somewhere must
        # never be written lock-free elsewhere
        for method, attr, line in cls.unlocked_writes:
            locks = cls.locked_writes.get(attr)
            if not locks:
                continue
            self.emit(
                "DX802", line,
                f"{cls.name}.{method} writes self.{attr} without "
                f"{'/'.join(sorted(locks))} (held for the same attribute "
                f"elsewhere in the class)",
            )
        for (a, b), line in cls.lock_orders.items():
            if (b, a) in cls.lock_orders and a < b:
                self.emit(
                    "DX802", line,
                    f"{cls.name} acquires {a} and {b} in conflicting "
                    f"orders (deadlock risk against the device-state "
                    f"lock discipline)",
                )


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
@dataclass
class RaceModuleSummary:
    path: str      # package-relative, e.g. "runtime/processor.py"
    functions: int

    def to_dict(self) -> dict:
        return {"path": self.path, "functions": self.functions}


@dataclass
class RaceCheckReport:
    """The ``--race`` tier's result. Unlike the flow tiers, the analyzed
    subject is the ENGINE — ``runtime/``, ``lq/``, ``pilot/`` — so a
    clean report certifies the runtime a flow deploys onto, for any
    flow."""

    flow: str
    modules: List[RaceModuleSummary]
    diagnostics: List[Diagnostic]
    allowed_zero_copy_sites: int = 0
    owner_handoff_sites: int = 0

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def race_dict(self) -> dict:
        return {
            "flow": self.flow,
            "analyzedFiles": len(self.modules),
            "modules": [m.to_dict() for m in self.modules],
            "allowedZeroCopySites": self.allowed_zero_copy_sites,
            "ownerHandoffSites": self.owner_handoff_sites,
        }

    def to_dict(self) -> dict:
        from .diagnostics import REPORT_SCHEMA_VERSION

        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "race": self.race_dict(),
        }


# the engine surface the standing CI race gate covers
ENGINE_PACKAGES = ("runtime", "lq", "pilot")


def engine_module_paths() -> List[str]:
    """Every .py file of the engine packages the gate analyzes."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: List[str] = []
    for pkg in ENGINE_PACKAGES:
        root = os.path.join(pkg_root, pkg)
        for dirpath, _dirs, files in os.walk(root):
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(out)


def _rel_path(path: str) -> str:
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rp = os.path.relpath(os.path.abspath(path), pkg_root)
    return rp.replace(os.sep, "/")


def analyze_modules(paths: List[str], flow: str = "") -> RaceCheckReport:
    """Run the DX8xx pass over explicit module files (the self-lint /
    fixture entry point)."""
    modules: List[RaceModuleSummary] = []
    diags: List[Diagnostic] = []
    allowed = 0
    handoffs = 0
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        lint = _ModuleLinter(path, _rel_path(path), src)
        lint.run()
        modules.append(RaceModuleSummary(lint.rel, lint.functions))
        diags.extend(lint.diags)
        allowed += lint.allowed_sites
        handoffs += lint.handoff_sites
    diags.sort(key=lambda d: (d.table, d.span.line, d.code))
    return RaceCheckReport(
        flow=flow, modules=modules, diagnostics=diags,
        allowed_zero_copy_sites=allowed, owner_handoff_sites=handoffs,
    )


# engine analysis cache: the race tier's subject is the engine source,
# which does not change between flows in one process — key on the
# module set + mtimes so an edited file re-analyzes (tests)
_ENGINE_CACHE: Dict[tuple, RaceCheckReport] = {}


def analyze_flow_race(flow: dict) -> RaceCheckReport:
    """Race-tier analysis for a flow config. The analyzed subject is
    the engine the flow would deploy onto (``runtime/``, ``lq/``,
    ``pilot/``) — the report is flow-independent except for the name it
    is filed under, and is cached per engine-source state."""
    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    name = (gui or {}).get("name") or ""
    paths = engine_module_paths()
    key = tuple(
        (p, os.path.getmtime(p)) for p in paths
    )
    cached = _ENGINE_CACHE.get(key)
    if cached is None:
        _ENGINE_CACHE.clear()
        cached = analyze_modules(paths)
        _ENGINE_CACHE[key] = cached
    return RaceCheckReport(
        flow=name,
        modules=cached.modules,
        diagnostics=cached.diagnostics,
        allowed_zero_copy_sites=cached.allowed_zero_copy_sites,
        owner_handoff_sites=cached.owner_handoff_sites,
    )
