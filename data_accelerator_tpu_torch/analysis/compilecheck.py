"""Compile-surface analyzer: prove a flow's dispatch surface closed, then
ship the manifest that warms it.

The ``--compile`` tier (DX6xx). It enumerates every entry point the
runtime can dispatch — the step (``runtime/processor.py
build_step_fn``) and one ``_slice_table``/``_pack_slot`` transfer
helper per reachable (output x pow2 capacity bucket) from the
sized-transfer lattice (``transfer_buckets``) — derives each entry's
signature (the argument tree and every leaf's shape and dtype) from a
run on ``meta`` tensors, and emits the **compile manifest**: entry ->
signature, static args, donation pattern, digest and cache key
(flow-hash x chip count x entry x signature). Config generation embeds
it into the conf (``datax.job.process.compile.manifest``), and
``FlowProcessor._aot_warm`` warms every entry at init instead of at the
first batch that needs it.

Port of the JAX package's ``analysis/compilecheck.py`` to the eager
step, which has no trace:

- The surface is what ``FlowProcessor._aot_warm`` warms: the step, and
  each output's transfer slots per ``transfer_buckets`` bucket. Entry
  names, signatures, donation patterns (the rings the step updates in
  place; the slot a pack writes into), the flow hash and the cache keys
  are the JAX tier's, on the same flow: the signature's ``tree`` is
  written in the form of a JAX tree definition (``tree_signature``).
- The digest is the sha256 of the aten op sequence the entry runs on
  ``meta`` (the dispatch-mode recording ``kernels/launch.py`` counts
  launches with), not of a StableHLO lowering. The manifest says which
  (``digestBackend``), and DX603 compares digests only between
  manifests of one backend; the report says whether it did
  (``digestsCompared``).
- DX601 is retired: it bounds the JAX package's transfer-helper jit
  cache (``process.compile.jitcachecap``), and the eager port has none.
  The registry keeps the code; this tier never emits it, and the
  manifest's ``jitCacheCap`` is null.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..compile.planner import TableData
from ..core.config import SettingDictionary, SettingNamespace
from ..core.schema import StringDictionary
from ..kernels.launch import MetaLaunchCounter
from ..runtime.processor import (
    PackedRaw,
    _pack_slot,
    _slice_table,
    load_reference_data_tables,
    transfer_buckets,
)
from ..runtime.timewindow import WindowBuffers
from .deviceplan import (
    FlowDevicePlan,
    _ordered,
    _plan_from_gui,
    meta_step,
    meta_step_args,
)
from .diagnostics import Diagnostic, make

# manifest document version (the JAX package's)
MANIFEST_VERSION = 1

# the arguments the step updates in place (the window rings): the JAX
# package's donated argnums, the same positions
STEP_DONATE_ARGNUMS = (1,)

# what this tier's digests hash: the aten ops an entry runs on meta
DIGEST_BACKEND = "torch-meta-ops"
# the JAX package's manifests carry no backend: theirs hash StableHLO
JAX_DIGEST_BACKEND = "jax-stablehlo"


def flow_config_hash(gui: dict) -> str:
    """Stable content hash of a flow config (canonical JSON), the flow
    component of every cache key."""
    return hashlib.sha256(
        json.dumps(gui, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


# ---------------------------------------------------------------------------
# Signatures: the JAX package's aval signature over torch tensors
# ---------------------------------------------------------------------------
def _tree(node, leaves: list) -> str:
    """The JAX tree-definition form of ``node`` (sorted dict keys, the
    custom nodes with their sorted column names as aux data), appending
    every tensor leaf to ``leaves`` in flatten order."""
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        return "*"
    if isinstance(node, (TableData, WindowBuffers)):
        names = tuple(sorted(node.cols))
        kids = [_tree(node.cols[n], leaves) for n in names]
        kids.append(_tree(node.valid, leaves))
        return (f"CustomNode({type(node).__name__}[{names!r}], "
                f"[{', '.join(kids)}])")
    if isinstance(node, PackedRaw):
        return (f"CustomNode(PackedRaw[{tuple(node.layout)!r}], "
                f"[{_tree(node.data, leaves)}])")
    if isinstance(node, dict):
        return "{" + ", ".join(
            f"{k!r}: {_tree(node[k], leaves)}" for k in sorted(node)
        ) + "}"
    if isinstance(node, (tuple, list)):
        kids = [_tree(x, leaves) for x in node]
        inner = ", ".join(kids) + ("," if len(kids) == 1 else "")
        return f"({inner})" if isinstance(node, tuple) else f"[{inner}]"
    if node is None:
        return "None"
    raise TypeError(f"no signature for {type(node).__name__}")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def tree_signature(tree) -> dict:
    """``aval_signature`` of the JAX package for a tree of tensors:
    its tree definition and every leaf's shape and dtype."""
    leaves: list = []
    text = _tree(tree, leaves)
    return {
        "tree": f"PyTreeDef({text})",
        "leaves": [[list(map(int, t.shape)), _dtype_name(t.dtype)] for t in leaves],
    }


def op_digest(fn, *args) -> str:
    """sha256 of the aten op sequence ``fn(*args)`` runs on meta (the
    recording ``kernels/launch.py::MetaLaunchCounter`` counts launches
    with)."""
    rec = MetaLaunchCounter()
    with rec:
        fn(*args)
    return hashlib.sha256("\n".join(rec.ops).encode()).hexdigest()


def _meta_like(t: TableData) -> TableData:
    return TableData(
        {c: torch.empty_like(v, device="meta") for c, v in t.cols.items()},
        torch.empty_like(t.valid, device="meta"),
    )


def compile_entries(
    step_args: tuple, outputs: Dict[str, TableData], sized: bool, slots: bool,
) -> List[dict]:
    """Every entry point the flow dispatches, manifest-shaped: the step
    over ``step_args`` and, per output (``outputs``: the step's meta
    results) and capacity bucket, the slice that sizes its transfer and
    the pack into its resident slot (a slice alone where the output
    holds no slot). The JAX package's ``compile_entries_from_avals``."""
    entries: List[dict] = [{
        "entry": "step",
        "donate": list(STEP_DONATE_ARGNUMS),
        "static": {},
        "avals": tree_signature(step_args),
    }]
    for name in sorted(outputs):
        t = outputs[name]
        full_cap = int(t.valid.shape[0])
        sliceable = all(
            tuple(v.shape[:1]) == tuple(t.valid.shape) for v in t.cols.values()
        )
        for cap in (transfer_buckets(full_cap) if sized else [full_cap]):
            if slots and sliceable:
                entries.append({
                    "entry": f"slice:{name}:{cap}", "donate": [],
                    "static": {"cap": cap}, "avals": tree_signature(t),
                })
                slot = _slice_table(t, cap)
                entries.append({
                    "entry": f"pack:{name}:{cap}", "donate": [1],
                    "static": {"cap": cap},
                    "avals": tree_signature((t, slot)),
                })
            elif cap < full_cap:
                entries.append({
                    "entry": f"slice:{name}:{cap}", "donate": [],
                    "static": {"cap": cap}, "avals": tree_signature(t),
                })
    return entries


def attach_digests(entries: List[dict], step_fn, step_args: tuple,
                   outputs: Dict[str, TableData]) -> None:
    """Each entry's op-sequence digest on meta. Mutates in place."""
    for e in entries:
        if e["entry"] == "step":
            e["loweringDigest"] = op_digest(step_fn, *step_args)
            continue
        kind, out, cap_s = e["entry"].split(":")
        cap, t = int(cap_s), outputs[out]
        if kind == "slice":
            e["loweringDigest"] = op_digest(_slice_table, t, cap)
        else:
            slot = _meta_like(_slice_table(t, cap))
            e["loweringDigest"] = op_digest(
                lambda a, b, c=cap: _pack_slot(_slice_table(a, c), b), t, slot,
            )


def build_manifest(
    flow_name: str, flow_hash: str, entries: List[dict], chips: int,
    stable: bool, sized: bool = True, slots: bool = True,
) -> dict:
    """The deployable manifest; each entry's ``cacheKey`` is the JAX
    package's (flow hash x chips x entry x signature)."""
    for e in entries:
        e["cacheKey"] = hashlib.sha256(
            f"{flow_hash}|chips={chips}|{e['entry']}|"
            f"{json.dumps(e['avals'], sort_keys=True)}".encode()
        ).hexdigest()[:16]
    return {
        "manifestVersion": MANIFEST_VERSION,
        "flow": flow_name,
        "flowHash": flow_hash,
        "chips": chips,
        "stable": stable,
        "jitCacheCap": None,
        "sized": sized,
        "slots": slots,
        "digestBackend": DIGEST_BACKEND,
        "entries": entries,
    }


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------
@dataclass
class CompileSurfaceReport:
    flow: str
    chips: int
    entries: List[dict]
    manifest: Optional[dict]
    diagnostics: List[Diagnostic]
    stable: bool = True
    # whether a checked manifest's digests were compared (same backend)
    digests_compared: Optional[bool] = None

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def compile_dict(self) -> dict:
        helper = [e for e in self.entries if e["entry"] != "step"]
        caps = sorted({e["static"]["cap"] for e in helper if "cap" in e["static"]})
        return {
            "flow": self.flow,
            "chips": self.chips,
            "entries": len(self.entries),
            "helperEntries": len(helper),
            "buckets": caps,
            "stable": self.stable,
            "jitCacheCap": None,
            "digestBackend": DIGEST_BACKEND,
            "digestsCompared": self.digests_compared,
            "manifest": self.manifest,
        }

    def to_dict(self) -> dict:
        from .diagnostics import REPORT_SCHEMA_VERSION

        return {
            "schemaVersion": REPORT_SCHEMA_VERSION,
            "ok": self.ok,
            "errorCount": len(self.errors),
            "warningCount": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "compile": self.compile_dict(),
        }


# ---------------------------------------------------------------------------
# The step's arguments on meta, from a flow config
# ---------------------------------------------------------------------------
def source_raw_form(input_type: Optional[str]) -> str:
    """``packed`` when dispatch ships a source of this input type as one
    ``PackedRaw`` matrix (the native decoder's path: any input but the
    local simulated one), else ``columns``: the JAX package's rule on
    one card, where the port's decoder is always built."""
    itype = (input_type or "local").lower()
    return "columns" if itype in ("", "local") else "packed"


def _source_types(gui: dict) -> Dict[str, str]:
    out: Dict[str, str] = {}
    iprops = (gui.get("input") or {}).get("properties") or {}
    if iprops.get("inputSchemaFile"):
        out["default"] = (gui.get("input") or {}).get("type") or "local"
    for src in (gui.get("input") or {}).get("sources") or []:
        sname = src.get("id") or src.get("name")
        if sname:
            out[sname] = src.get("type") or "local"
    return out


def _source_refdata_names(gui: dict) -> List[str]:
    return [
        rd.get("id")
        for rd in (gui.get("input") or {}).get("referenceData") or []
        if rd.get("id") and (rd.get("properties") or {}).get("path")
    ]


def _refdata_tables(gui: dict) -> Dict[str, TableData]:
    """Reference tables on meta: the CSVs load through the runtime's
    ``load_reference_data_tables`` (their row count is part of the
    signature). Raises when a declared file is unreadable."""
    entries = (gui.get("input") or {}).get("referenceData") or []
    conf: Dict[str, str] = {}
    ns = SettingNamespace.JobInputPrefix + "referencedata."
    for rd in entries:
        name = rd.get("id")
        props = rd.get("properties") or {}
        if not name or not props.get("path"):
            continue
        conf[f"{ns}{name}.path"] = props["path"]
        if props.get("delimiter"):
            conf[f"{ns}{name}.delimiter"] = props["delimiter"]
        if props.get("header") is not None:
            conf[f"{ns}{name}.header"] = str(props["header"])
    if not conf:
        return {}
    tables = load_reference_data_tables(
        SettingDictionary(conf), StringDictionary(), torch.device("cpu")
    )
    return {n: _meta_like(t) for n, (_s, t) in tables.items()}


# ---------------------------------------------------------------------------
# Lints
# ---------------------------------------------------------------------------
def _lint_surface(bundle: FlowDevicePlan, diags: List[Diagnostic]) -> bool:
    """DX600 over the enumerated surface. Returns ``stable``: whether
    the manifest covers every signature the flow can ever dispatch.
    DX601 (the jit-cache bound) is retired in the port."""
    stable = True
    if bundle.udf_refresh_names:
        stable = False
        diags.append(make(
            "DX600", "",
            f"open dispatch surface: UDF(s) {sorted(bundle.udf_refresh_names)} "
            f"declare interval refresh — every state change rebuilds the "
            f"step with a NEW signature, so the signature set is "
            f"unbounded over the job's lifetime; the manifest covers the "
            f"initial surface only and the warm degrades to best-effort "
            f"(rebuilds surface as Retrace_Count / Compile_WarmMiss_Count)",
        ))
    if bundle.uses_string_ops and bundle.dict_max_size is None:
        stable = False
        diags.append(make(
            "DX600", "",
            "open dispatch surface: device string ops with an unbounded "
            "dictionary — dictionary growth past the aux-table capacity "
            "rebuilds the string-op tables at a new shape per growth "
            "step, so the signature set grows without bound; set "
            "process.stringdictionary.maxsize to close the surface",
        ))
    return stable


def check_manifest(manifest: dict, derived: List[dict],
                   diags: List[Diagnostic]) -> bool:
    """A shipped manifest against the derived surface: a donation
    disagreement is DX602, any other entry, signature, static-argument
    or (same backend only) digest disagreement DX603. Returns whether
    digests were compared."""
    backend = manifest.get("digestBackend") or JAX_DIGEST_BACKEND
    compare_digests = backend == DIGEST_BACKEND
    shipped = {
        e.get("entry"): e for e in manifest.get("entries", []) if isinstance(e, dict)
    }
    fresh = {e["entry"]: e for e in derived}
    missing = sorted(set(fresh) - set(shipped))
    extra = sorted(set(shipped) - set(fresh))
    if missing or extra:
        diags.append(make(
            "DX603", "",
            f"manifest drift: entry sets disagree with the derived surface "
            f"(missing from manifest: {missing or 'none'}; stale in "
            f"manifest: {extra or 'none'}) — regenerate the manifest",
        ))
    for name in sorted(set(shipped) & set(fresh)):
        m, d = shipped[name], fresh[name]
        if list(m.get("donate") or []) != list(d["donate"]):
            diags.append(make(
                "DX602", name,
                f"donation/aliasing mismatch: manifest records donated "
                f"argnums {m.get('donate')} but the runtime contract is "
                f"{d['donate']} — the manifest describes buffers written "
                f"in place that the dispatch path does not (or the "
                f"reverse)",
            ))
        drift = []
        if m.get("avals") != d["avals"]:
            drift.append("aval signature")
        if (
            compare_digests
            and d.get("loweringDigest") and m.get("loweringDigest")
            and m["loweringDigest"] != d["loweringDigest"]
        ):
            drift.append("lowering digest")
        if m.get("static") != d["static"]:
            drift.append("static args")
        if drift:
            diags.append(make(
                "DX603", name,
                f"manifest drift on {', '.join(drift)}: the shipped "
                f"manifest no longer matches this flow — a warm start from "
                f"it would build anyway (DX604 at runtime); regenerate the "
                f"manifest",
            ))
    return compare_digests


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def analyze_flow_compile(
    flow: dict,
    chips: Optional[int] = None,
    manifest: Optional[dict] = None,
    digests: bool = True,
) -> CompileSurfaceReport:
    """Compile-surface analysis of a flow config (gui JSON or full flow
    document), on ``meta``: the production planner's views, the
    runtime's step, no device. ``manifest``: one to check for drift
    (DX602/DX603). ``digests=False`` skips the op-sequence digests."""
    gui = flow.get("gui") if isinstance(flow.get("gui"), dict) else flow
    name = gui.get("name") or ""
    diags: List[Diagnostic] = []
    plan_diags: List[Diagnostic] = []
    n_chips = chips or 1
    bundle = _plan_from_gui(gui, plan_diags, chips)
    for d in plan_diags:
        code = "DX690" if d.code == "DX290" else "DX691"
        diags.append(make(code, d.table, d.message, d.span))
    if bundle is None:
        return CompileSurfaceReport(name, n_chips, [], None, _ordered(diags),
                                    stable=False)
    try:
        refdata = _refdata_tables(gui)
        args = meta_step_args(
            bundle, {s: source_raw_form(t) for s, t in _source_types(gui).items()},
            refdata,
        )
    except Exception as e:  # noqa: BLE001 — e.g. unreadable refdata CSV
        diags.append(make(
            "DX691", "",
            f"compile surface unavailable: step inputs cannot be derived "
            f"at design time ({e})",
        ))
        return CompileSurfaceReport(name, n_chips, [], None, _ordered(diags),
                                    stable=False)
    try:
        step_fn = meta_step(bundle, _source_refdata_names(gui))
        outputs = step_fn(*args)[0]
        entries = compile_entries(args, outputs, sized=True, slots=True)
        if digests:
            attach_digests(entries, step_fn, args, outputs)
    except Exception as e:  # noqa: BLE001 — any evaluation failure is a finding
        diags.append(make("DX690", "", f"compile-surface evaluation failed: {e}"))
        return CompileSurfaceReport(name, n_chips, [], None, _ordered(diags),
                                    stable=False)
    stable = _lint_surface(bundle, diags)
    compared = check_manifest(manifest, entries, diags) if manifest is not None else None
    doc = build_manifest(name, flow_config_hash(gui), entries, n_chips, stable)
    return CompileSurfaceReport(name, n_chips, entries, doc, _ordered(diags),
                                stable=stable, digests_compared=compared)


def analyze_processor_compile(
    proc, manifest: Optional[dict] = None, digests: bool = True,
) -> CompileSurfaceReport:
    """Compile-surface analysis of a built ``FlowProcessor``: its own
    views, rings, state and tables, evaluated on ``meta`` (the surface
    its ``_aot_warm`` warms)."""
    from .deviceplan import flow_plan_from_processor

    diags: List[Diagnostic] = []
    bundle = flow_plan_from_processor(proc)
    forms = {n: source_raw_form(s.conf.get("inputtype")) for n, s in proc.specs.items()}
    refdata = {n: _meta_like(t) for n, (_s, t) in proc.refdata.items()}
    args = meta_step_args(bundle, forms, refdata)
    step_fn = meta_step(bundle, list(proc.refdata))
    outputs = step_fn(*args)[0]
    entries = compile_entries(
        args, outputs, sized=proc.sized_transfer, slots=proc.output_slots_enabled,
    )
    if digests:
        attach_digests(entries, step_fn, args, outputs)
    stable = _lint_surface(bundle, diags)
    compared = check_manifest(manifest, entries, diags) if manifest is not None else None
    doc = build_manifest(
        proc.dict.get("datax.job.name") or "", "", entries, 1, stable,
        sized=proc.sized_transfer, slots=proc.output_slots_enabled,
    )
    return CompileSurfaceReport(doc["flow"], 1, entries, doc, _ordered(diags),
                                stable=stable, digests_compared=compared)


def warmed_entries(proc) -> List[Tuple[str, int]]:
    """The (output, capacity) transfer slots a warmed processor holds:
    what ``_aot_warm`` staged, for holding a manifest against it."""
    return sorted(proc._slots)
