"""The port's compile-surface tier (``analysis/compilecheck.py``, DX6xx)
against the JAX package's (``tests/test_compilecheck.py``).

- On every golden flow the port's manifest has the JAX tier's entries:
  names, signatures (tree and leaves), donation patterns and static
  arguments; the flow hash and cache keys too wherever the port reads
  the flow text unchanged (a UDF flow names the port's own module, so
  its text, and with it the hash, differs). The diagnostics are equal
  but for DX601.
- The deliberate differences, pinned: DX601 is retired (the port has
  no jit cache: never emitted, still in the registry, ``jitCacheCap``
  null); the digests hash the aten op sequence on ``meta``, and DX603
  compares them only against a manifest of the same backend.
- The processor surface equals the flow surface, and it is what
  ``FlowProcessor._aot_warm`` warms: a host booted from the manifest
  reports no ``Compile_WarmMiss_Count``.
"""

import copy
import json
import os

import pytest

from data_accelerator_tpu.analysis import compilecheck as jcomp
from data_accelerator_tpu_torch.analysis import compilecheck as tcomp
from data_accelerator_tpu_torch.analysis.diagnostics import CODES
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

FLOWS_DIR = os.path.join(os.path.dirname(__file__), "data", "flows")
FLOWS = sorted(f[:-5] for f in os.listdir(FLOWS_DIR) if f.endswith(".json"))
ENTRY_FIELDS = ("entry", "donate", "static", "avals")


def _to_port(text: str) -> str:
    return (text.replace("tests.data.udfs.", "tests.data.udfs_torch.")
            .replace("dx305_pallas", "dx305_cuda")
            .replace("data_accelerator_tpu.udf.samples",
                     "data_accelerator_tpu_torch.udf.samples"))


def _flows(name):
    with open(os.path.join(FLOWS_DIR, name + ".json")) as f:
        text = f.read()
    return json.loads(text), json.loads(_to_port(text)), _to_port(text) == text


# the DX305 fixture's Pallas UDF calls pallas_call without its output
# shape, which fails the JAX tier's trace (DX690); the port's fixture
# names a CUDA kernel whose plain version evaluates on meta
JAX_ONLY_FAILURE = {"dx305_udf_pallas"}


@pytest.mark.parametrize("name", sorted(set(FLOWS) - JAX_ONLY_FAILURE))
def test_manifest_entries_equal_the_jax_tiers(name):
    jflow, tflow, same_text = _flows(name)
    j = jcomp.analyze_flow_compile(jflow, digests=False)
    t = tcomp.analyze_flow_compile(tflow, digests=False)
    jd = [(d.code, d.severity, d.table) for d in j.diagnostics if d.code != "DX601"]
    assert [(d.code, d.severity, d.table) for d in t.diagnostics] == jd
    assert t.ok == j.ok or "DX601" in j.codes()
    assert t.stable == j.stable
    assert (t.manifest is None) == (j.manifest is None)
    if t.manifest is None:
        return
    strip = lambda m: [{k: e[k] for k in ENTRY_FIELDS} for e in m["entries"]]  # noqa: E731
    assert strip(t.manifest) == strip(j.manifest)
    top = lambda m: {k: m[k] for k in ("manifestVersion", "flow", "chips", "stable",  # noqa: E731
                                       "sized", "slots")}
    assert top(t.manifest) == top(j.manifest)
    if same_text:
        assert t.manifest["flowHash"] == j.manifest["flowHash"]
        assert [e["cacheKey"] for e in t.manifest["entries"]] == \
            [e["cacheKey"] for e in j.manifest["entries"]]


def test_the_kernel_udf_flow_evaluates_in_the_port():
    jflow, tflow, _ = _flows("dx305_udf_pallas")
    assert jcomp.analyze_flow_compile(jflow, digests=False).codes() == ["DX690"]
    t = tcomp.analyze_flow_compile(tflow)
    assert t.ok and t.entries[0]["entry"] == "step"


def test_dx601_is_retired_in_the_port():
    """Pinned difference: the reference bounds its transfer-helper jit
    cache (DX601 on the bucket blow-up fixture); the port has no jit
    cache, never emits DX601, and its manifest carries no cap."""
    jflow, tflow, _ = _flows("dx601_bucket_blowup")
    assert "DX601" in jcomp.analyze_flow_compile(jflow, digests=False).codes()
    t = tcomp.analyze_flow_compile(tflow, digests=False)
    assert "DX601" not in t.codes() and t.ok
    assert "DX601" in CODES
    assert t.manifest["jitCacheCap"] is None
    assert t.compile_dict()["jitCacheCap"] is None


@pytest.mark.parametrize("code", ["DX602", "DX603"])
def test_a_tampered_manifest_is_caught(code):
    _j, flow, _ = _flows("dx603_manifest_drift")
    fresh = tcomp.analyze_flow_compile(flow)
    assert fresh.ok and fresh.manifest["digestBackend"] == tcomp.DIGEST_BACKEND
    tampered = copy.deepcopy(fresh.manifest)
    if code == "DX602":
        tampered["entries"][0]["donate"] = []
    else:
        tampered["entries"][0]["avals"]["leaves"][0][0][0] += 1
    report = tcomp.analyze_flow_compile(flow, manifest=tampered)
    assert code in report.codes() and not report.ok
    # the port's own manifest checks clean, digests compared
    clean = tcomp.analyze_flow_compile(flow, manifest=fresh.manifest)
    assert clean.diagnostics == [] and clean.digests_compared is True


def test_digests_compare_only_within_one_backend():
    """A JAX manifest (StableHLO digests) checks clean against the port's
    surface: entries, signatures and donations agree, and the digests
    are not compared, which the report says. A port manifest whose step
    digest changed is DX603."""
    jflow, tflow, _ = _flows("dx603_manifest_drift")
    jman = jcomp.analyze_flow_compile(jflow).manifest
    report = tcomp.analyze_flow_compile(tflow, manifest=jman)
    assert report.diagnostics == [] and report.digests_compared is False
    assert report.compile_dict()["digestsCompared"] is False
    own = copy.deepcopy(tcomp.analyze_flow_compile(tflow).manifest)
    own["entries"][0]["loweringDigest"] = "0" * 64
    drift = tcomp.analyze_flow_compile(tflow, manifest=own)
    assert [d.code for d in drift.diagnostics] == ["DX603"]
    assert "lowering digest" in drift.diagnostics[0].message


def test_digests_are_stable_and_follow_the_flow():
    _j, flow, _ = _flows("dx603_manifest_drift")
    a = tcomp.analyze_flow_compile(flow).manifest["entries"]
    b = tcomp.analyze_flow_compile(flow).manifest["entries"]
    assert [e["loweringDigest"] for e in a] == [e["loweringDigest"] for e in b]
    assert len({e["loweringDigest"] for e in a if e["entry"] == "step"}) == 1
    other = copy.deepcopy(flow)
    other["process"]["queries"] = [q.replace("AVG", "MAX") for q in other["process"]["queries"]]
    c = tcomp.analyze_flow_compile(other).manifest["entries"]
    assert c[0]["loweringDigest"] != a[0]["loweringDigest"]


def _conf_for_gui(gui, extra=None) -> dict:
    """The flat conf config generation would write for a fixture gui."""
    from data_accelerator_tpu_torch.compile.codegen import CodegenEngine
    from data_accelerator_tpu_torch.serve.flowbuilder import RuleDefinitionGenerator

    proc = gui["process"]
    rc = CodegenEngine().generate_code(
        "\n".join(proc["queries"]),
        RuleDefinitionGenerator().generate(gui.get("rules") or [], gui["name"]),
        gui["name"], windowable_tables={"DataXProcessedInput"},
    )
    conf = {
        "datax.job.name": gui["name"],
        "datax.job.input.default.blobschemafile":
            gui["input"]["properties"]["inputSchemaFile"],
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.process.timestampcolumn": proc.get("timestampColumn", ""),
        "datax.job.process.watermark": proc.get("watermark", "0 second"),
        "datax.job.process.projection":
            gui["input"]["properties"].get("normalizationSnippet", "Raw.*"),
        "datax.job.process.transform": rc.code,
        "datax.job.process.batchcapacity": "4096",
    }
    for wname, dur in rc.time_windows.items():
        conf[f"datax.job.process.timewindow.{wname}.windowduration"] = dur
    for tables, _sink in rc.outputs:
        for t in tables.split(","):
            conf[f"datax.job.output.{t.strip()}.metric"] = "enabled"
    conf.update(extra or {})
    return conf


def test_processor_surface_is_the_flow_surface_and_what_the_warm_stages():
    _j, flow, _ = _flows("dx603_manifest_drift")
    flow = copy.deepcopy(flow)
    flow["process"].setdefault("jobconfig", {})["jobBatchCapacity"] = "4096"
    static = tcomp.analyze_flow_compile(flow)
    conf = _conf_for_gui(flow)
    proc = FlowProcessor(SettingDictionary(conf), device="cpu")
    runtime = tcomp.analyze_processor_compile(proc)
    s = {e["entry"]: e for e in static.entries}
    r = {e["entry"]: e for e in runtime.entries}
    assert set(s) == set(r)
    for name in s:
        for field in ("donate", "static", "avals", "loweringDigest"):
            assert s[name][field] == r[name][field], (name, field)
    warmed = FlowProcessor(SettingDictionary(dict(
        conf, **{"datax.job.process.compile.manifest": json.dumps(static.manifest)})),
        device="cpu")
    assert warmed._aot_warmed
    helpers = sorted({(e["entry"].split(":")[1], e["static"]["cap"])
                      for e in static.entries if e["entry"] != "step"})
    assert tcomp.warmed_entries(warmed) == helpers


def test_a_host_booted_from_the_manifest_misses_no_warm(tmp_path):
    from data_accelerator_tpu_torch.runtime import host as host_mod

    _j, flow, _ = _flows("dx603_manifest_drift")
    flow = copy.deepcopy(flow)
    flow["process"].setdefault("jobconfig", {})["jobBatchCapacity"] = "64"
    manifest = tcomp.analyze_flow_compile(flow, digests=False).manifest
    conf = _conf_for_gui(flow, {
        "datax.job.process.batchcapacity": "64",
        "datax.job.process.compile.manifest": json.dumps(manifest),
        "datax.job.input.default.eventhub.maxrate": "64",
    })
    for out in [k.split(".")[3] for k in conf if k.endswith(".metric")]:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    host = host_mod.StreamingHost(SettingDictionary(conf), device="cpu")
    try:
        host.run(max_batches=3)
    finally:
        host.stop()
    names = {k.split(":", 1)[1]
             for k in host.metric_logger.store.keys(f"DATAX-{flow['name']}:")}
    assert "Compile_ColdStart_Ms" in names
    assert "Compile_WarmMiss_Count" not in names
