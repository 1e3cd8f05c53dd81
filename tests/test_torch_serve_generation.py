"""The port's runtime-config generation (``serve/generation.py``)
against the JAX package's: both generators, each over its own storage,
take the same designer documents, and their flat confs are equal key by
key (the storage roots aside) with these exceptions, each asserted:

(a) the conformance model (S620) is the port's ``analyze_flow_device``
    plan. On these documents it also equals the JAX package's model:
    both plans price a design-time flow alike (the config-1 flow with
    the anomaly query at 262,144 rows is 144,388,096 bytes in both;
    133,902,336 is the plan of the same flow without that query);
(b) the compile manifest (S630) is the port's: its entries' names,
    signatures, donations and statics equal the JAX manifest's, its
    digests and ``digestBackend`` are the port's own;
(c) the generator writes no module path of its own: a UDF's class path
    is the document's, so a document naming the port's UDF yields the
    port's path where the JAX document names the JAX one;
(d) a multi-card job (``jobNumChips`` > 1) raises ``EngineException``
    naming multi-GPU slice 8 before any stage runs, where the JAX
    package generates it with its mesh model.

Job names stay the reference's (``DataXTpu-<flow>``). Strings and ints
compare exactly; the plans' numbers too (they are integer byte counts
and exact FLOP counts).
"""

import json
import os

import pytest

import chip_smoke
from data_accelerator_tpu.serve import flowbuilder as jfb
from data_accelerator_tpu.serve import generation as jgen
from data_accelerator_tpu.serve import storage as jst
from data_accelerator_tpu_torch.analysis import analyze_flow_device
from data_accelerator_tpu_torch.core.config import EngineException
from data_accelerator_tpu_torch.serve import flowbuilder as tfb
from data_accelerator_tpu_torch.serve import generation as tgen
from data_accelerator_tpu_torch.serve import storage as tst

from test_designer_e2e import WX_SCHEMA, designer_gui
from test_serve_generation import make_gui

PACKAGES = {"jax": (jfb, jgen, jst), "torch": (tfb, tgen, tst)}
PORT_UDF, JAX_UDF = "data_accelerator_tpu_torch.udf.", "data_accelerator_tpu.udf."
ENTRY_FIELDS = ("entry", "donate", "static", "avals")
MANIFEST_TOP = ("manifestVersion", "flow", "chips", "stable", "sized", "slots")
PROC = "datax.job.process."


def _pilot_gui():
    gui = make_gui("PilotKnobs")
    gui["process"]["jobconfig"].update({
        "jobPilotWindowSeconds": "2.5", "jobPilotBudget": "3", "jobStallEwmaMs": "1500",
        "jobPipelineDepth": "4", "jobDecoderThreads": "2", "jobObservabilityPort": "9107",
        "jobLqMaxFanin": "16", "jobHbmSample": "false",
    })
    return gui


def _multi_source_gui():
    gui = make_gui("MultiSource")
    gui["input"]["sources"] = [{"id": "weather", "type": "socket", "properties": {
        "inputSchemaFile": WX_SCHEMA, "target": "Weather",
        "normalizationSnippet": "current_timestamp() AS eventTimeStamp\nRaw.*",
        "socket.port": "0"}}]
    gui["process"]["queries"] = [
        "--DataXQuery--\nDoorEvents = SELECT deviceDetails.deviceId AS deviceId, "
        "eventTimeStamp FROM DataXProcessedInput;\n--DataXQuery--\n"
        "Storm = SELECT d.deviceId, w.windSpeed FROM DoorEvents d INNER JOIN "
        "Weather TIMEWINDOW('10 seconds') w ON d.deviceId = w.stationId;\n"
        "OUTPUT Storm TO Metrics;"]
    return gui


def _designer_gui():
    gui = designer_gui("DesignerAgg")
    gui["process"]["functions"][0]["properties"]["module"] = PORT_UDF + "samples:anomalyscore"
    return gui


GUIS = {
    "make_gui": lambda: make_gui("GenParity"),
    "designer_aggregate_rule": _designer_gui,
    "config1_anomaly": lambda: chip_smoke.main_flow_gui(4096),
    "control_socket": lambda: chip_smoke.control_gui("socket", 4096),
    "pilot_knobs": _pilot_gui,
    "multi_source": _multi_source_gui,
    "no_model_no_manifest": lambda: dict(make_gui("OptOut"), process=dict(
        make_gui("OptOut")["process"], jobconfig={
            "jobNumChips": "1", "jobBatchCapacity": "512",
            "jobConformanceModel": "false", "jobCompileManifest": "false"})),
}


def _for(pkg: str, gui: dict) -> dict:
    """The document as each package's designer holds it: UDF class paths
    name that package's modules."""
    text = json.dumps(gui)
    return json.loads(text.replace(PORT_UDF, JAX_UDF) if pkg == "jax" else text)


def _generate(pkg, root, gui):
    fb, gen, st = PACKAGES[pkg]
    design = st.LocalDesignTimeStorage(os.path.join(root, "design"))
    runtime = st.LocalRuntimeStorage(os.path.join(root, "runtime"))
    design.save(fb.FlowConfigBuilder().build(_for(pkg, gui)))
    res = gen.RuntimeConfigGeneration(design, runtime).generate(gui["name"])
    assert res.ok, res.errors
    assert len(res.conf_paths) == 1
    with open(res.conf_paths[0], encoding="utf-8") as f:
        conf = dict(ln.split("=", 1) for ln in f.read().splitlines() if "=" in ln)
    files = {rel: text for rel, text in res.files.items()}
    return res, {k: v.replace(root, "@ROOT@") for k, v in conf.items()}, files, design


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = {}
    for case, make in GUIS.items():
        gui = make()
        root = tmp_path_factory.mktemp(case)
        out[case] = (gui, {pkg: _generate(pkg, str(root / pkg), gui) for pkg in PACKAGES})
    return out


@pytest.mark.parametrize("case", sorted(GUIS))
def test_flat_conf_equals_the_reference_key_by_key(generated, case):
    gui, runs = generated[case]
    (jres, jconf, jfiles, _jd), (tres, tconf, tfiles, tdesign) = runs["jax"], runs["torch"]
    assert tres.job_names == jres.job_names == [f"DataXTpu-{gui['name']}"]
    assert sorted(tconf) == sorted(jconf)
    for key in sorted(jconf):
        want, got = jconf[key], tconf[key]
        if key == PROC + "conformance.model":
            # (a) the port's plan, equal here to the JAX package's model
            doc = tdesign.get_by_name(gui["name"])
            plan = json.dumps(analyze_flow_device(doc).runtime_model(),
                              separators=(",", ":"))
            assert got == plan
            assert json.loads(got) == json.loads(want)
        elif key.startswith(PROC + "jar.ud"):
            # (c) the document's path, each package's own
            assert want.startswith(JAX_UDF) and got == want.replace(JAX_UDF, PORT_UDF)
        else:
            assert got == want, key
    assert sorted(tfiles) == sorted(jfiles)
    for rel in sorted(jfiles):
        if rel.endswith("compile.manifest.json"):
            continue
        assert tfiles[rel].replace(PORT_UDF, JAX_UDF) == jfiles[rel], rel
    assert tres.metrics == jres.metrics


@pytest.mark.parametrize("case", sorted(GUIS))
def test_compile_manifest_is_the_ports_with_the_references_entries(generated, case):
    """(b)"""
    _gui, runs = generated[case]
    jfiles, tfiles = runs["jax"][2], runs["torch"][2]
    [jrel] = [r for r in jfiles if r.endswith("compile.manifest.json")] or [None]
    [trel] = [r for r in tfiles if r.endswith("compile.manifest.json")] or [None]
    # both or neither (the aggregate rule's flow fails both compile tiers,
    # and the fail-open leaves it without a manifest in both)
    assert (jrel is None) == (trel is None)
    if case == "no_model_no_manifest":
        assert jrel is None
    if jrel is None:
        return
    jm, tm = json.loads(jfiles[jrel]), json.loads(tfiles[trel])
    assert {k: tm[k] for k in MANIFEST_TOP} == {k: jm[k] for k in MANIFEST_TOP}
    strip = lambda m: [{k: e[k] for k in ENTRY_FIELDS} for e in m["entries"]]  # noqa: E731
    assert strip(tm) == strip(jm)
    assert tm["digestBackend"] and "digestBackend" not in jm
    assert tm["jitCacheCap"] is None


def test_config1_conformance_model_is_present(generated):
    """The fail-open on S620 stays; the config-1 flow must not hide a
    fault of the port's plan behind it."""
    gui, runs = generated["config1_anomaly"]
    model = json.loads(runs["torch"][1][PROC + "conformance.model"])
    assert model["stages"] and model["totals"]["hbmBytes"] > 0
    assert {s["name"] for s in model["stages"]} >= set(chip_smoke.OUTPUTS)
    assert runs["torch"][1][PROC + "compile.manifest"].endswith("compile.manifest.json")


def test_config1_plan_at_full_capacity_equals_the_references():
    """The numbers the issue of this slice named: the main flow with the
    anomaly query at 262,144 rows is 144,388,096 bytes in both packages;
    the config-1 queries alone (the committed fixture's flow) 133,902,336."""
    from data_accelerator_tpu.analysis import analyze_flow_device as janalyze
    from test_torch_genconf import designer_gui as genconf_gui

    main = chip_smoke.main_flow_gui()
    assert analyze_flow_device(main).totals()["hbmBytes"] == 144_388_096
    assert janalyze(_for("jax", main)).totals()["hbmBytes"] == 144_388_096
    gen1 = genconf_gui(chip_smoke.CAPACITY)
    assert analyze_flow_device(gen1).totals()["hbmBytes"] == 133_902_336
    assert janalyze(gen1).totals()["hbmBytes"] == 133_902_336


@pytest.mark.parametrize("chips", ["2", "8"])
def test_multi_card_job_raises_naming_slice_8(tmp_path, chips):
    """(d)"""
    gui = make_gui("MultiCard")
    gui["process"]["jobconfig"]["jobNumChips"] = chips
    jres, jconf, _f, _d = _generate("jax", str(tmp_path / "jax"), gui)
    assert jconf[PROC + "numchips"] == chips
    with pytest.raises(EngineException, match="slice 8"):
        _generate("torch", str(tmp_path / "torch"), gui)
    # before any stage: nothing was written, no job was recorded
    runtime = tst.LocalRuntimeStorage(str(tmp_path / "torch" / "runtime"))
    assert runtime.list_files("MultiCard") == [] and runtime.list_files("jobs") == []


def test_legacy_executor_field_is_refused_too(tmp_path):
    gui = make_gui("Legacy")
    gui["process"]["jobconfig"] = {"jobNumExecutors": "4", "jobBatchCapacity": "512"}
    with pytest.raises(EngineException, match="4 cards"):
        _generate("torch", str(tmp_path), gui)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_missing_and_unsafe_flows_fail_alike(tmp_path, pkg):
    fb, gen, st = PACKAGES[pkg]
    design = st.LocalDesignTimeStorage(str(tmp_path / "design"))
    runtime = st.LocalRuntimeStorage(str(tmp_path / "runtime"))
    assert gen.RuntimeConfigGeneration(design, runtime).generate("NoSuchFlow").errors == [
        "flow 'NoSuchFlow' not found"]
    gui = make_gui("GenTestFlow")
    gui["name"] = "../escape"
    design.save({"name": "../escape", "gui": gui})
    res = gen.RuntimeConfigGeneration(design, runtime).generate("../escape")
    assert not res.ok and "invalid flow name" in res.errors[0]


def test_generation_records_the_job_and_the_doc(generated):
    gui, runs = generated["make_gui"]
    tres, _conf, _files, tdesign = runs["torch"]
    doc = tdesign.get_by_name(gui["name"])
    assert doc["jobNames"] == tres.job_names and doc.get("metrics")
