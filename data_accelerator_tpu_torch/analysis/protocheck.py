"""Exactly-once protocol analysis over the ENGINE'S OWN modules
(the ``--protocol`` tier, DX9xx).

The delivery guarantee — sink emit -> durable checkpoint / pointer
flip -> FIFO ack -> offset commit, plus the rescale A/B handoff — is
hand-ordered code in ``runtime/host.py``, ``runtime/checkpoint.py``,
``runtime/statetable.py`` and ``serve/jobs.py``, defended until now
only by chaos drills that sample interleavings. This pass makes the
ordering machine-checked the way ``racecheck.py`` made the
donation/zero-copy bug class machine-checked: per engine entry point
it extracts a typed EFFECT TRACE of protocol events (the
``protospec.py`` vocabulary: SINK_EMIT, DURABLE_WRITE, POINTER_FLIP,
FIFO_ACK, OFFSET_COMMIT, STATE_PUSH, REQUEUE, DRAIN_MARKER, plus the
handoff pair HANDOFF_PULL/DISPATCH) and checks the lexical
happens-before order against the declared rule table.

Effect extraction (call-pattern recognition, like the provenance
seeds of the race tier):

- ``SINK_EMIT``     — ``<dispatcher>.dispatch(...)``, ``<sink>.write(...)``
- ``POINTER_FLIP``  — ``.persist()``, ``<processor>.commit()``,
  ``put_pointer`` on a non-mirror store
- ``DURABLE_WRITE`` — ``os.fsync``, ``os.replace``,
  ``_durable_replace``, ``put_files`` on a non-mirror store,
  ``<checkpointer>.save(...)``
- ``FIFO_ACK``      — ``.ack()``;  ``OFFSET_COMMIT`` —
  ``.checkpoint_batch(...)`` / ``.write_offsets(...)``
- ``STATE_PUSH``    — ``push_window_partitions``, ``put_files`` /
  ``put_pointer`` on a mirror store
- ``REQUEUE``       — ``.requeue_unacked()``;  ``DRAIN_MARKER`` —
  ``_settle_landings`` / ``_drain_landings``
- ``HANDOFF_PULL``  — ``_state_partition_plan(...)`` or stamping
  ``rec["statePartitionsOwned"]`` / ``rec["confOverrides"]``
- ``DISPATCH``      — ``<client>.submit(...)``

The checks (per function, main-path = outside except handlers,
lexical order):

- **DX900** — a FIFO_ACK before the POINTER_FLIP; also any
  ``os.replace`` without an fsync of the tmp file BEFORE the rename
  and of the parent directory AFTER it (the power-loss
  durability contract).
- **DX901** — a POINTER_FLIP before the SINK_EMIT.
- **DX902** — more than one main-path ack call site in one function.
- **DX903** — a function that acks whose failure handler does not
  requeue the whole unacked window (and: a looped ack requires a
  looped requeue — one source's requeue does not cover the window).
- **DX904** — a pre-ack effect outside any try whose handler
  requeues, or a post-ack effect without an explicit
  ``post-commit`` marker.
- **DX905** — a handoff function whose first successor DISPATCH
  precedes its first HANDOFF_PULL.

Marker contract (``# dx-proto:`` structured comments, same
span-forwarding semantics as ``# dx-race:``)
--------------------------------------------------------------------
Line-scoped (same line, or above — covering the next statement's
full span):

- ``# dx-proto: post-commit <reason>`` — pins a DESIGNED post-ack
  effect (DX904): the interval-gated window-snapshot + offset
  checkpoint block is at-least-once replay territory ON PURPOSE;
  counted and reported so the self-lint keeps an inventory.

Function-scoped (any line inside the function):

- ``# dx-proto: requeue-upstream <reason>`` — exempts a delegating
  ack wrapper from DX903: the requeue obligation is discharged by the
  caller that owns the batch failure handler.

The runtime counterpart is ``runtime/protocolmonitor.py`` (conf
``datax.job.process.debug.protocolmonitor``): records each batch's
ACTUAL event sequence into the flight recorder and validates its
linearization against the same ``protospec`` rule objects, firing
runtime **DX906** events — the dynamic ground truth the DX90x
fixtures and the seeded ack-before-durability regression test are
proven against.

Copy of the JAX package's ``analysis/protocheck.py``: the gate covers
the port's ``runtime/``, ``lq/`` and ``pilot/`` plus the rescale
handoff in the port's ``serve/jobs.py``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, Span, make
from .racecheck import (
    _collect_markers,
    _dotted,
    _fn_markers,
    _Markers,
    _rel_path,
    engine_module_paths,
)
from .protospec import (
    DISPATCH,
    DRAIN_MARKER,
    DURABLE_WRITE,
    EFFECT_KINDS,
    FIFO_ACK,
    HANDOFF_PULL,
    OFFSET_COMMIT,
    POINTER_FLIP,
    REQUEUE,
    SINK_EMIT,
    STATE_PUSH,
)

_MARKER_RE = re.compile(r"#\s*dx-proto:\s*([a-z-]+)\s*(.*)$")

# subscript keys whose stamping on a job record IS the handoff pull
_HANDOFF_KEYS = {"statePartitionsOwned", "confOverrides"}

_DRAIN_CALLS = {"_settle_landings", "_drain_landings"}


@dataclass
class _Event:
    """One extracted protocol event with its control-flow context."""

    kind: str
    line: int
    col: int
    detail: str
    in_handler: bool  # inside an except handler
    guarded: bool     # inside a try whose handler requeues
    looped: bool      # inside a For/While body


def _classify_call(node: ast.Call) -> Optional[Tuple[str, str]]:
    """Map one call to its protocol event kind, or None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        base = _dotted(func.value)
        bl = base.lower()
        attr = func.attr
        if attr == "dispatch" and bl.endswith("dispatcher"):
            return SINK_EMIT, f"{base}.dispatch"
        if attr == "write" and "sink" in bl:
            return SINK_EMIT, f"{base}.write"
        if attr == "persist" and not node.args:
            return POINTER_FLIP, f"{base}.persist"
        if attr == "commit" and bl.endswith("processor"):
            return POINTER_FLIP, f"{base}.commit"
        if attr == "put_pointer":
            if "mirror" in bl:
                return STATE_PUSH, f"{base}.put_pointer"
            return POINTER_FLIP, f"{base}.put_pointer"
        if attr == "put_files":
            if "mirror" in bl:
                return STATE_PUSH, f"{base}.put_files"
            return DURABLE_WRITE, f"{base}.put_files"
        if attr == "push_window_partitions":
            return STATE_PUSH, f"{base}.push_window_partitions"
        if attr in ("checkpoint_batch", "write_offsets"):
            return OFFSET_COMMIT, f"{base}.{attr}"
        if attr == "ack" and not node.args:
            return FIFO_ACK, f"{base}.ack"
        if attr == "requeue_unacked":
            return REQUEUE, f"{base}.requeue_unacked"
        if attr == "fsync" and base == "os":
            return DURABLE_WRITE, "os.fsync"
        if attr == "replace" and base == "os":
            return DURABLE_WRITE, "os.replace"
        if attr == "save" and "checkpoint" in bl:
            return DURABLE_WRITE, f"{base}.save"
        if attr in _DRAIN_CALLS:
            return DRAIN_MARKER, f"{base}.{attr}"
        if attr == "_state_partition_plan":
            return HANDOFF_PULL, f"{base}._state_partition_plan"
        if attr == "submit" and bl.endswith("client"):
            return DISPATCH, f"{base}.submit"
    elif isinstance(func, ast.Name):
        if func.id == "_durable_replace":
            return DURABLE_WRITE, "_durable_replace"
        if func.id in _DRAIN_CALLS:
            return DRAIN_MARKER, func.id
    return None


def _handler_has_requeue(handlers: List[ast.ExceptHandler]) -> bool:
    for h in handlers:
        for sub in ast.walk(h):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "requeue_unacked":
                return True
    return False


class _FnProto:
    """Effect-trace extraction + rule check over one function body."""

    def __init__(self, linter: "_ModuleLinter", node, cls_name: str,
                 method_name: str, fn_marks: Set[str]):
        self.l = linter
        self.node = node
        self.cls_name = cls_name
        self.method = method_name
        self.marks = fn_marks
        self.events: List[_Event] = []

    def _where(self) -> str:
        return (
            f"{self.cls_name}.{self.method}" if self.cls_name
            else self.method
        )

    # -- extraction ----------------------------------------------------
    def _leaf(self, st: ast.stmt, in_handler: bool, guarded: bool,
              looped: bool) -> None:
        """Harvest events from a non-compound statement (or a compound
        statement's header expression)."""
        for sub in ast.walk(st):
            if isinstance(sub, ast.Call):
                hit = _classify_call(sub)
                if hit is not None:
                    self.events.append(_Event(
                        hit[0], sub.lineno, sub.col_offset, hit[1],
                        in_handler, guarded, looped,
                    ))
        # handoff stamping: rec["statePartitionsOwned"] = ...
        if isinstance(st, ast.Assign):
            for target in st.targets:
                if isinstance(target, ast.Subscript) and \
                        isinstance(target.slice, ast.Constant) and \
                        target.slice.value in _HANDOFF_KEYS:
                    self.events.append(_Event(
                        HANDOFF_PULL, st.lineno, st.col_offset,
                        f'["{target.slice.value}"]=',
                        in_handler, guarded, looped,
                    ))

    def _expr_events(self, expr: Optional[ast.AST], in_handler: bool,
                     guarded: bool, looped: bool) -> None:
        if expr is None:
            return
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                hit = _classify_call(sub)
                if hit is not None:
                    self.events.append(_Event(
                        hit[0], sub.lineno, sub.col_offset, hit[1],
                        in_handler, guarded, looped,
                    ))

    def _stmts(self, body: List[ast.stmt], in_handler: bool,
               guarded: bool, looped: bool) -> None:
        for st in body:
            if isinstance(st, ast.Try):
                covers = guarded or _handler_has_requeue(st.handlers)
                self._stmts(st.body, in_handler, covers, looped)
                for h in st.handlers:
                    self._stmts(h.body, True, guarded, looped)
                self._stmts(st.orelse, in_handler, guarded, looped)
                self._stmts(st.finalbody, in_handler, guarded, looped)
            elif isinstance(st, ast.If):
                self._expr_events(st.test, in_handler, guarded, looped)
                self._stmts(st.body, in_handler, guarded, looped)
                self._stmts(st.orelse, in_handler, guarded, looped)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._expr_events(st.iter, in_handler, guarded, looped)
                self._stmts(st.body, in_handler, guarded, True)
                self._stmts(st.orelse, in_handler, guarded, looped)
            elif isinstance(st, ast.While):
                self._expr_events(st.test, in_handler, guarded, looped)
                self._stmts(st.body, in_handler, guarded, True)
                self._stmts(st.orelse, in_handler, guarded, looped)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._expr_events(
                        item.context_expr, in_handler, guarded, looped,
                    )
                self._stmts(st.body, in_handler, guarded, looped)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested function (landing worker bodies): its own
                # entry point, analyzed with a fresh trace
                nested = _FnProto(
                    self.l, st, self.cls_name,
                    f"{self.method}.{st.name}",
                    _fn_markers(self.l.markers, st),
                )
                nested.run()
            elif isinstance(st, ast.ClassDef):
                pass
            else:
                self._leaf(st, in_handler, guarded, looped)

    # -- rule checking -------------------------------------------------
    def run(self) -> None:
        self._stmts(self.node.body, False, False, False)
        self.events.sort(key=lambda e: (e.line, e.col))
        self.l.effect_events += sum(
            1 for e in self.events if e.kind in EFFECT_KINDS
        )
        self._check()

    def _first(self, events: List[_Event], kind: str) -> Optional[_Event]:
        return next((e for e in events if e.kind == kind), None)

    def _check(self) -> None:
        main = [e for e in self.events if not e.in_handler]
        where = self._where()

        # DX900 (ordering half): ack before the pointer flip
        ack = self._first(main, FIFO_ACK)
        flip = self._first(main, POINTER_FLIP)
        if ack is not None and flip is not None and \
                (ack.line, ack.col) < (flip.line, flip.col):
            self.l.emit(
                "DX900", ack.line,
                f"{where} acks the upstream FIFO ({ack.detail}) before "
                f"the durable pointer flip ({flip.detail} at line "
                f"{flip.line}) — a crash between them loses the batch",
            )

        # DX900 (durability half): os.replace must be fenced by an
        # fsync of the tmp file before it and of the parent dir after
        for ev in self.events:
            if ev.detail != "os.replace":
                continue
            syncs = [e for e in self.events if e.detail == "os.fsync"]
            before = any(
                (e.line, e.col) < (ev.line, ev.col) for e in syncs
            )
            after = any(
                (e.line, e.col) > (ev.line, ev.col) for e in syncs
            )
            if not (before and after):
                missing = []
                if not before:
                    missing.append("tmp-file fsync before the rename")
                if not after:
                    missing.append("parent-dir fsync after it")
                self.l.emit(
                    "DX900", ev.line,
                    f"os.replace in {where} without "
                    f"{' and '.join(missing)} — a crash-then-power-"
                    f"loss can surface a zero-length checkpoint",
                )

        # DX901: pointer flip before the sink emit
        sink = self._first(main, SINK_EMIT)
        if sink is not None and flip is not None and \
                (flip.line, flip.col) < (sink.line, sink.col):
            self.l.emit(
                "DX901", flip.line,
                f"{where} flips the pointer ({flip.detail}) before the "
                f"sink emit ({sink.detail} at line {sink.line}) — "
                f"replay double-counts the committed rows",
            )

        # DX902: more than one main-path ack call site
        ack_sites = sorted({
            (e.line, e.col) for e in main if e.kind == FIFO_ACK
        })
        if len(ack_sites) > 1:
            self.l.emit(
                "DX902", ack_sites[1][0],
                f"{where} has {len(ack_sites)} ack call sites in one "
                f"batch path — a second ack releases a window the "
                f"failure path still expects to requeue",
            )

        # DX903/DX904 apply only to functions that ack a batch
        if ack is None:
            self._check_handoff(main, where)
            return

        handler_requeues = [
            e for e in self.events if e.in_handler and e.kind == REQUEUE
        ]
        if "requeue-upstream" in self.marks:
            # delegating ack wrapper: the caller owns the failure
            # handler, so the requeue-scope checks do not apply here
            self.l.requeue_upstream_sites += 1
            self._check_handoff(main, where)
            return
        if not handler_requeues:
            self.l.emit(
                "DX903", ack.line,
                f"{where} acks the upstream FIFO but no failure "
                f"handler requeues the unacked window (mark "
                f"`# dx-proto: requeue-upstream` if the caller owns "
                f"the handler)",
            )
            # with no requeue scope at all, DX904's outside-the-scope
            # placement checks have nothing to anchor to
            self._check_handoff(main, where)
            return
        if ack.looped and not any(e.looped for e in handler_requeues):
            self.l.emit(
                "DX903", handler_requeues[0].line,
                f"{where} acks every source but its failure handler "
                f"requeues only one — the requeue must cover the "
                f"whole unacked window",
            )

        last_ack_line = max(
            e.line for e in main if e.kind == FIFO_ACK
        )
        for ev in main:
            if ev.kind not in EFFECT_KINDS:
                continue
            if ev.kind == POINTER_FLIP and ev.line > last_ack_line:
                # a flip after the ack is DX900's finding (ordering),
                # not an undeclared post-commit effect
                continue
            if ev.line <= last_ack_line:
                if not ev.guarded:
                    self.l.emit(
                        "DX904", ev.line,
                        f"pre-ack effect {ev.detail} in {where} sits "
                        f"outside any try whose handler requeues — a "
                        f"failure after it strands the batch half-"
                        f"applied with the window still acked-pending",
                    )
            elif self.l.line_marked(ev.line, "post-commit"):
                self.l.post_commit_sites += 1
            else:
                self.l.emit(
                    "DX904", ev.line,
                    f"post-ack effect {ev.detail} in {where} without a "
                    f"`# dx-proto: post-commit` marker — effects after "
                    f"the ack are at-least-once replay territory and "
                    f"must be declared",
                )
        self._check_handoff(main, where)

    def _check_handoff(self, main: List[_Event], where: str) -> None:
        # DX905: first successor dispatch before the handoff pull
        pull = self._first(main, HANDOFF_PULL)
        disp = self._first(main, DISPATCH)
        if pull is not None and disp is not None and \
                (disp.line, disp.col) < (pull.line, pull.col):
            self.l.emit(
                "DX905", disp.line,
                f"{where} dispatches a successor ({disp.detail}) "
                f"before pulling its owned-partition plan "
                f"({pull.detail} at line {pull.line}) — the replica "
                f"boots without its state assignment",
            )


class _ModuleLinter:
    """One engine module: parse, walk every class/function, emit."""

    def __init__(self, path: str, rel: str, src: str):
        self.path = path
        self.rel = rel
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.markers: _Markers = _collect_markers(
            self.lines, self.tree, marker_re=_MARKER_RE,
        )
        self.diags: List[Diagnostic] = []
        self._seen: Set[Tuple[str, int]] = set()
        self.effect_events = 0
        self.post_commit_sites = 0
        self.requeue_upstream_sites = 0
        self.functions = 0

    def line_marked(self, line: int, kind: str) -> bool:
        return self.markers.line_has(line, kind)

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
                for item in node.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._function(item, cls_name=node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(node, cls_name="")

    def _function(self, node, cls_name: str) -> None:
        self.functions += 1
        fn = _FnProto(
            self, node, cls_name, node.name,
            _fn_markers(self.markers, node),
        )
        fn.run()


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
@dataclass
class ProtoModuleSummary:
    path: str       # package-relative, e.g. "runtime/host.py"
    functions: int
    events: int     # extracted effect events (EFFECT_KINDS members)

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "functions": self.functions,
            "events": self.events,
        }


@dataclass
class ProtoCheckReport:
    """The ``--protocol`` tier's result. Like the race tier, the
    analyzed subject is the ENGINE (plus the rescale handoff in
    ``serve/jobs.py``) — a clean report certifies the delivery
    protocol of the runtime any flow deploys onto."""

    flow: str
    modules: List[ProtoModuleSummary]
    diagnostics: List[Diagnostic]
    effect_events: int = 0
    post_commit_sites: int = 0
    requeue_upstream_sites: int = 0

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def protocol_dict(self) -> dict:
        return {
            "flow": self.flow,
            "analyzedFiles": len(self.modules),
            "modules": [m.to_dict() for m in self.modules],
            "effectEvents": self.effect_events,
            "postCommitSites": self.post_commit_sites,
            "requeueUpstreamSites": self.requeue_upstream_sites,
        }

    def to_dict(self) -> dict:
        from .diagnostics import REPORT_SCHEMA_VERSION

        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "protocol": self.protocol_dict(),
        }


PROTO_EXTRA_MODULES = (os.path.join("serve", "jobs.py"),)


def proto_module_paths() -> List[str]:
    """The engine packages plus the rescale-handoff module."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = list(engine_module_paths())
    for rel in PROTO_EXTRA_MODULES:
        out.append(os.path.join(pkg_root, rel))
    return sorted(out)


def analyze_proto_modules(
    paths: List[str], flow: str = "",
) -> ProtoCheckReport:
    """Run the DX90x pass over explicit module files (the self-lint /
    fixture entry point)."""
    modules: List[ProtoModuleSummary] = []
    diags: List[Diagnostic] = []
    effects = 0
    post_commit = 0
    requeue_upstream = 0
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        lint = _ModuleLinter(path, _rel_path(path), src)
        lint.run()
        modules.append(ProtoModuleSummary(
            lint.rel, lint.functions, lint.effect_events,
        ))
        diags.extend(lint.diags)
        effects += lint.effect_events
        post_commit += lint.post_commit_sites
        requeue_upstream += lint.requeue_upstream_sites
    diags.sort(key=lambda d: (d.table, d.span.line, d.code))
    return ProtoCheckReport(
        flow=flow, modules=modules, diagnostics=diags,
        effect_events=effects, post_commit_sites=post_commit,
        requeue_upstream_sites=requeue_upstream,
    )


# engine analysis cache, keyed on module set + mtimes (same contract
# as the race tier: the subject is the engine source, not the flow)
_ENGINE_CACHE: Dict[tuple, ProtoCheckReport] = {}


def analyze_flow_protocol(flow: dict) -> ProtoCheckReport:
    """Protocol-tier analysis for a flow config. The analyzed subject
    is the engine the flow would deploy onto plus the rescale handoff
    — flow-independent except for the name the report is filed under,
    cached per engine-source state."""
    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    name = (gui or {}).get("name") or ""
    paths = proto_module_paths()
    key = tuple(
        (p, os.path.getmtime(p)) for p in paths
    )
    cached = _ENGINE_CACHE.get(key)
    if cached is None:
        _ENGINE_CACHE.clear()
        cached = analyze_proto_modules(paths)
        _ENGINE_CACHE[key] = cached
    return ProtoCheckReport(
        flow=name,
        modules=cached.modules,
        diagnostics=cached.diagnostics,
        effect_events=cached.effect_events,
        post_commit_sites=cached.post_commit_sites,
        requeue_upstream_sites=cached.requeue_upstream_sites,
    )
