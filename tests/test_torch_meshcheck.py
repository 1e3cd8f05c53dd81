"""The port's mesh-sharding tier (``analysis/meshcheck.py``, the --mesh
tier, DX7xx) against the JAX package's (``tests/test_meshcheck.py``),
case by case.

- Parity: each flow goes to both packages' ``analyze_flow_mesh`` at the
  same chip count and the same explicit fleet spec (model only), and the
  two give equal diagnostic codes and tables, stage names, kinds, axes,
  scaling, rows, bytes, reshard edges (result and wire bytes) and
  totals. The flows: the DX7xx golden fixtures and their ``_clean``
  twins, the shipped scenario flows, the ``clean_*`` flows, and the
  main flow (config 1 plus the anomaly query) at chips 2, 4 and 8.
- The reference's cases: the golden codes, the shared kernel-UDF
  origin of DX700/DX704, the self-lint (every shipped and clean flow
  validated, its census equal to the model exactly), the plan's axes,
  the broadcast state join, a processor over a mesh, the chip-count
  parser, the CLI's exit codes, the REST answer equal to the CLI's, and
  the S660 generation stage.
- The port's own cross-check: the mesh step runs over virtual shards of
  the CPU as well as ``meta``, a gather the plan lacks, a missing one, a
  byte mismatch and a step that raises are DX790, and a host over 4 CPU
  virtual shards with a generated sharding model reads a
  ``Conformance_MeshIci_Ratio`` equal to census / model.

Deliberate differences (ROADMAP queue C): the cross-check reads the mesh
step's census instead of an HLO lowering, so ``validated`` holds on one
device and DX791 is left to flows with no plan; the latency model is
uncalibrated without a caller's profile; DX700 names the CUDA kernel
UDF.
"""

import json
import os

import pytest

import chip_smoke
from data_accelerator_tpu.analysis import FleetSpec as JFleetSpec
from data_accelerator_tpu.analysis import analyze_flow_mesh as janalyze_mesh
from data_accelerator_tpu.serve.scenarios import shipped_flow_guis as jshipped
from data_accelerator_tpu_torch.analysis import (
    CODES,
    ChipCountError,
    FleetSpec,
    SEV_ERROR,
    SEV_WARNING,
    analyze_flow,
    analyze_flow_mesh,
    analyze_processor_mesh,
    meshcheck,
    parse_chip_count,
)
from data_accelerator_tpu_torch.analysis.__main__ import main as port_main
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.dist import make_mesh
from data_accelerator_tpu_torch.serve.scenarios import shipped_flow_guis

FLOWS_DIR = os.path.join(os.path.dirname(__file__), "data", "flows")
GB16 = 16 * 1024 ** 3
# the fleet the CPU's cases are judged against (the default is the card's)
CPU = FleetSpec(device="cpu")


def _to_port(text: str) -> str:
    return (
        text.replace("tests.data.udfs.", "tests.data.udfs_torch.")
        .replace("dx305_pallas", "dx305_cuda")
        .replace("data_accelerator_tpu.udf.samples",
                 "data_accelerator_tpu_torch.udf.samples")
    )


def load_flow(name: str) -> dict:
    with open(os.path.join(FLOWS_DIR, name + ".json")) as f:
        return json.loads(_to_port(f.read()))


def load_jax_flow(name: str) -> dict:
    with open(os.path.join(FLOWS_DIR, name + ".json")) as f:
        return json.load(f)


def clean_flow_names():
    return sorted(f[:-5] for f in os.listdir(FLOWS_DIR)
                  if f.startswith("clean_") and f.endswith(".json"))


def _specs(chips, **kw):
    """One fleet for both packages: the port's unset fields are its
    machine's, the reference's a TPU's, so every field is given."""
    fields = {"hbm_per_chip_bytes": GB16, "ici_bytes_per_sec_per_chip": 450e9, **kw}
    return (JFleetSpec(chips=chips, **fields),
            FleetSpec(chips=chips, device="cpu", **fields))


# tiny fleet specs the DX702/DX703 fixtures are judged against
_TINY_HBM = {"hbm_per_chip_bytes": 1 << 20}
_TINY_ICI = {"ici_bytes_per_sec_per_chip": 125_000.0}

# (fixture, code, severity, spec override or None)
MESH_GOLDEN = [
    ("dx700_unshardable_order", "DX700", SEV_WARNING, None),
    ("dx701_repeated_reshard", "DX701", SEV_WARNING, None),
    ("dx702_perchip_hbm", "DX702", SEV_ERROR, _TINY_HBM),
    ("dx703_ici_budget", "DX703", SEV_WARNING, _TINY_ICI),
    ("dx704_scaling_cliff", "DX704", SEV_WARNING, None),
    ("dx705_mesh_transfer", "DX705", SEV_WARNING, None),
    ("dx790_mesh_lowering", "DX790", SEV_ERROR, None),
    ("dx791_mesh_unavailable", "DX791", SEV_WARNING, None),
]


def _plan(report) -> dict:
    """Everything the two packages' reports must hold equal."""
    return {
        "codes": [(d.code, d.severity, d.table) for d in report.diagnostics],
        "stages": [
            {k: v for k, v in s.to_dict().items() if k not in ("loweredBytes",)}
            for s in report.stages
        ],
        "totals": report.totals(),
    }


def _both(jflow, tflow, chips, **spec):
    jspec, tspec = _specs(chips, **spec)
    return (janalyze_mesh(jflow, chips=chips, spec=jspec, lower=False),
            analyze_flow_mesh(tflow, chips=chips, spec=tspec, lower=False))


# ---------------------------------------------------------------------------
# parity with the reference, flow by flow
# ---------------------------------------------------------------------------
PARITY = ([g[0] for g in MESH_GOLDEN] + [g[0] + "_clean" for g in MESH_GOLDEN]
          + clean_flow_names())


@pytest.mark.parametrize("name", PARITY)
def test_plan_equals_the_reference(name):
    spec = next((g[3] for g in MESH_GOLDEN if name.startswith(g[0])), None) or {}
    jrep, trep = _both(load_jax_flow(name), load_flow(name), 8, **spec)
    assert _plan(trep) == _plan(jrep)


def test_shipped_flows_equal_the_reference():
    jflows, tflows = jshipped(), shipped_flow_guis()
    assert [g["name"] for g in tflows] == [g["name"] for g in jflows]
    for jflow, tflow in zip(jflows, tflows):
        jrep, trep = _both(jflow, tflow, 8)
        assert _plan(trep) == _plan(jrep)


@pytest.mark.parametrize("chips", [2, 4, 8])
def test_main_flow_equals_the_reference(chips):
    """The slice's main flow at full width: at 4 chips the totals are
    60,817,408 result bytes, 182,452,224 wire bytes and 3 reshards."""
    tflow = chip_smoke.main_flow_gui()
    jflow = json.loads(json.dumps(tflow).replace(
        "data_accelerator_tpu_torch.udf.", "data_accelerator_tpu.udf."))
    jrep, trep = _both(jflow, tflow, chips)
    assert _plan(trep) == _plan(jrep)
    assert [d.code for d in trep.diagnostics] == ["DX700", "DX704", "DX705"]
    if chips == 4:
        t = trep.totals()
        assert (t["iciResultBytesPerBatch"], t["iciWireBytesPerBatch"],
                t["reshardCount"], t["perChipHbmBytes"]) == (
            60_817_408, 182_452_224.0, 3, 38_080_512)


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fixture,code,severity,spec", MESH_GOLDEN,
                         ids=[g[0] for g in MESH_GOLDEN])
def test_golden_mesh_diagnostic(fixture, code, severity, spec):
    flow = load_flow(fixture)
    assert analyze_flow(flow).errors == []
    tspec = _specs(8, **(spec or {}))[1]
    report = analyze_flow_mesh(flow, chips=8, spec=tspec, lower=False)
    hits = [d for d in report.diagnostics if d.code == code]
    assert hits, f"expected {code}, got {report.codes()}"
    assert hits[0].severity == severity
    assert hits[0].severity == CODES[code][0]
    assert report.ok == (severity != SEV_ERROR)
    twin = load_flow(fixture + "_clean")
    twin_report = analyze_flow_mesh(twin, chips=8, spec=tspec, lower=False)
    assert code not in twin_report.codes(), (
        f"{fixture}_clean still reports {code}: "
        f"{[d.render() for d in twin_report.diagnostics]}"
    )
    assert twin_report.ok


def test_dx700_and_dx704_share_the_pallas_origin():
    """A kernel-UDF stage is both structurally unshardable (DX700, which
    names the CUDA kernel UDF) and the scaling cliff (DX704)."""
    report = analyze_flow_mesh(load_flow("dx704_scaling_cliff"), chips=8, lower=False, spec=CPU)
    assert {"DX700", "DX704"} <= set(report.codes())
    dx700 = next(d for d in report.diagnostics if d.code == "DX700")
    assert "CUDA kernel UDF anomalyscore" in dx700.message
    scored = next(s for s in report.stages if s.name == "Scored")
    assert (scored.axis, scored.scaling) == ("replicated", "replicated")
    twin = analyze_flow_mesh(load_flow("dx704_scaling_cliff_clean"), chips=8, lower=False, spec=CPU)
    assert next(s for s in twin.stages if s.name == "Scored").axis == "data"


def _self_lint_flows():
    flows = [(g.get("name"), g) for g in shipped_flow_guis()]
    flows += [(n, load_flow(n)) for n in clean_flow_names()]
    assert len(flows) >= 6
    return flows


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_mesh_self_lint_shipped_and_baseline_flows_exact(device):
    """Every shipped and clean flow analyzes clean at --chips=8, its plan
    validated by the mesh step over 8 virtual shards (``meta``, and the
    CPU with zero-filled tables), the census equal to the model gather
    by gather, and one all-reduce of the counts vector beside."""
    for name, flow in _self_lint_flows():
        report = analyze_flow_mesh(flow, chips=8, device=device, spec=CPU)
        assert report.errors == [], (name, [d.render() for d in report.errors])
        assert report.validated and report.stages, name
        check = report.cross_check
        assert (check.device, check.shards) == (device, 8)
        for s in report.stages:
            assert s.lowered_bytes == s.ici_result_bytes, (name, s.name)
        assert [e["censusBytes"] for e in check.edges] == [
            e["modelBytes"] for e in check.edges], name
        assert check.census["all-reduce"]["count"] == 1
        assert check.all_reduce_bytes == check.census["all-reduce"]["resultBytes"] > 0
        gathered = check.census.get("all-gather", {"count": 0, "resultBytes": 0})
        t = report.totals()
        assert gathered == {"count": t["reshardCount"],
                            "resultBytes": t["iciResultBytesPerBatch"]}
        assert t["chips"] == 8
        assert t["iciWireBytesPerBatch"] >= t["iciResultBytesPerBatch"]


def test_partition_plan_axes_follow_the_mesh_layout():
    report = analyze_flow_mesh(load_flow("clean_config2_window_agg"), chips=8,
                               lower=False, spec=CPU)
    by = {s.name: s for s in report.stages}
    assert by["input:default"].axis == "data"
    assert by["DataXProcessedInput"].axis == "data"
    assert by["ring:DataXProcessedInput"].axis == "data"
    agg = next(s for s in report.stages if s.kind == "group")
    assert (agg.axis, agg.scaling) == ("replicated", "collective")
    assert len(agg.reshards) == 1
    edge = agg.reshards[0]
    win = next(s for s in report.stages if s.kind == "window")
    assert edge.result_bytes == win.hbm_bytes
    assert edge.wire_bytes == edge.result_bytes * 7
    assert by["ring:DataXProcessedInput"].per_chip_bytes == (
        -(-by["ring:DataXProcessedInput"].hbm_bytes // 8))


def test_state_join_right_side_replicates_without_reshard():
    report = analyze_flow_mesh(load_flow("clean_config3_state_join"), chips=8,
                               lower=False, spec=CPU)
    for s in report.stages:
        for e in s.reshards:
            assert not e.table.startswith("state:"), (s.name, e.table)
    assert any(s.kind == "state" and s.axis == "replicated" for s in report.stages)


def test_processor_mesh_parity_with_flow_analysis(tmp_path):
    """``analyze_processor_mesh`` over a processor on 8 CPU virtual
    shards: its mesh sets the chips, the plan validates, and the
    sharded output gathers at the step boundary."""
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
    from test_dist import make_conf

    conf = SettingDictionary(dict(make_conf(tmp_path).dict))
    proc = FlowProcessor(conf, batch_capacity=256,
                         mesh=make_mesh(8, devices=("cpu",) * 8),
                         output_datasets=["Hot", "PerDevice"])
    for device in ("meta", "cpu"):
        report = analyze_processor_mesh(proc, device=device, spec=CPU)
        assert report.chips == 8 and report.validated and report.errors == []
        by = {s.name: s for s in report.stages}
        assert by["Hot"].axis == "data"
        assert by["PerDevice"].axis == "replicated"
        assert any(e.table.endswith("(output boundary)") for e in by["Hot"].reshards)
        for s in report.stages:
            assert s.lowered_bytes == s.ici_result_bytes


def test_parse_chip_count_contract():
    assert parse_chip_count(None) is None
    assert parse_chip_count("") is None
    assert parse_chip_count("8") == 8
    assert parse_chip_count(16) == 16
    for bad in ("0", "-2", 0, -1, "eight", 2.5, True):
        with pytest.raises(ChipCountError):
            parse_chip_count(bad)
    with pytest.raises(ChipCountError, match="--chips"):
        parse_chip_count("0", "--chips")
    with pytest.raises(ChipCountError, match="fleet"):
        parse_chip_count(-3, "fleet spec 'chips'")
    assert issubclass(ChipCountError, ValueError)


def test_fleet_spec_chips_use_shared_parser():
    assert FleetSpec.from_dict({"chips": 4}, device="cpu").chips == 4
    with pytest.raises(ChipCountError):
        FleetSpec.from_dict({"chips": 0}, device="cpu")
    with pytest.raises(ChipCountError):
        FleetSpec.from_dict({"chips": "many"}, device="cpu")


# -- the CLI, in process ---------------------------------------------------------
def _run_cli(argv, capsys):
    rc = port_main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _port_files(tmp_path, names):
    paths = []
    for name in names:
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(load_flow(name)))
        paths.append(str(p))
    return paths


def test_cli_mesh_zero_exit_on_clean_configs(tmp_path, capsys):
    paths = _port_files(tmp_path, clean_flow_names())
    for i, gui in enumerate(shipped_flow_guis()):
        p = tmp_path / f"scenario{i}.json"
        p.write_text(json.dumps(gui))
        paths.append(str(p))
    rc, out, err = _run_cli(["--mesh", "--chips=8", "--fleet-device=cpu", *paths], capsys)
    assert rc == 0, (out, err)
    assert out.count("mesh plan (8 chips, validated)") == len(paths)


def test_cli_mesh_nonzero_on_lowering_error(tmp_path, capsys):
    [path] = _port_files(tmp_path, ["dx790_mesh_lowering"])
    rc, out, _ = _run_cli(["--mesh", "--fleet-device=cpu", path], capsys)
    assert rc == 1 and "DX790" in out
    rc, out, _ = _run_cli([path], capsys)
    assert rc == 0, out


def test_cli_mesh_warning_keeps_zero_exit(tmp_path, capsys):
    [path] = _port_files(tmp_path, ["dx700_unshardable_order"])
    rc, out, _ = _run_cli(["--mesh", "--fleet-device=cpu", path], capsys)
    assert rc == 0 and "DX700" in out


def test_cli_usage_exit_2_covers_mesh_flags(tmp_path, capsys):
    [path] = _port_files(tmp_path, ["clean_config2_window_agg"])
    rc, _o, err = _run_cli(["--mesh", "--chips=0", path], capsys)
    assert rc == 2 and "chip count must be >= 1" in err
    rc, _o, err = _run_cli(["--mesh", "--chips=abc", path], capsys)
    assert rc == 2 and "invalid chip count" in err
    rc, _o, err = _run_cli(["--mehs", path], capsys)
    assert rc == 2 and "unknown flag" in err
    rc, _o, err = _run_cli([], capsys)
    assert rc == 2 and "--mesh" in err


def _api(tmp_path):
    from test_torch_serve_restapi import make_api

    return make_api("torch", str(tmp_path / "api"))


@pytest.mark.parametrize("flow", ["dx700_unshardable_order", "main_flow"])
def test_cli_mesh_json_matches_validate_endpoint(tmp_path, capsys, flow):
    """REST ``flow/validate {"mesh": true, "chips": N}`` and the CLI's
    ``--mesh --chips=N --json`` share one implementation: identical
    diagnostics and sharding plans, the cross-check's block included."""
    gui = (chip_smoke.main_flow_gui(4096) if flow == "main_flow"
           else load_flow(flow))
    path = tmp_path / "flow.json"
    path.write_text(json.dumps(gui))
    rc, out, err = _run_cli(
        ["--mesh", "--chips=4", "--fleet-device=cpu", "--json", str(path)], capsys)
    assert rc == 0, err
    cli_report = json.loads(out)
    assert cli_report["mesh"]["stages"] and cli_report["mesh"]["validated"] is True
    api = _api(tmp_path)
    try:
        status, res = api.dispatch("POST", "api/flow/validate",
                                   body={"flow": gui, "mesh": True, "chips": 4})
    finally:
        api.livequery.stop()
    assert status == 200
    assert res["result"]["diagnostics"] == cli_report["diagnostics"]
    assert res["result"]["mesh"] == cli_report["mesh"]


def test_validate_endpoint_rejects_bad_chips(tmp_path):
    api = _api(tmp_path)
    try:
        status, out = api.dispatch("POST", "api/flow/validate", body={
            "flow": load_flow("clean_config2_window_agg"), "mesh": True, "chips": 0})
    finally:
        api.livequery.stop()
    assert status == 400
    assert "chip count" in out["error"]["message"]


# -- generation S660 ---------------------------------------------------------------
def _flow_ops(tmp_path):
    from data_accelerator_tpu_torch.serve.flowservice import FlowOperation
    from data_accelerator_tpu_torch.serve.storage import (
        LocalDesignTimeStorage,
        LocalRuntimeStorage,
    )

    return FlowOperation(LocalDesignTimeStorage(str(tmp_path / "d")),
                         LocalRuntimeStorage(str(tmp_path / "r")),
                         fleet_admission=False, device="cpu")


def _conf_dict(conf_path):
    conf = {}
    for line in open(conf_path, encoding="utf-8"):
        if "=" in line:
            k, _, v = line.partition("=")
            conf[k] = v.rstrip("\n")
    return conf


def test_generation_embeds_mesh_model_for_mesh_jobs(tmp_path):
    gui = load_flow("clean_config2_window_agg")
    gui["name"] = "mesh-embed"
    gui.setdefault("process", {}).setdefault("jobconfig", {})["jobNumChips"] = "8"
    fo = _flow_ops(tmp_path)
    fo.save_flow(gui)
    res = fo.generate_configs("mesh-embed")
    assert res.ok, res.errors
    conf = _conf_dict(res.conf_paths[0])
    model = json.loads(conf["datax.job.process.mesh.model"])
    assert model["totals"]["chips"] == 8
    assert model["totals"]["iciWireBytesPerBatch"] > 0
    assert model["totals"]["reshardCount"] >= 1
    assert any(s["axis"] == "replicated" for s in model["stages"])
    assert model == analyze_flow_mesh(gui, chips=8, lower=False, spec=CPU).runtime_model()
    from data_accelerator_tpu_torch.core.config import parse_conf_lines

    props = parse_conf_lines(open(res.conf_paths[0], encoding="utf-8").readlines())
    assert json.loads(props["datax.job.process.mesh.model"]) == model


def test_generation_skips_mesh_model_for_single_chip(tmp_path):
    gui = load_flow("clean_config2_window_agg")
    gui["name"] = "mesh-single"
    fo = _flow_ops(tmp_path)
    fo.save_flow(gui)
    res = fo.generate_configs("mesh-single")
    assert res.ok, res.errors
    assert "mesh.model" not in open(res.conf_paths[0]).read()


def test_generation_mesh_model_opt_out(tmp_path):
    gui = load_flow("clean_config2_window_agg")
    gui["name"] = "mesh-optout"
    gui.setdefault("process", {}).setdefault("jobconfig", {}).update(
        {"jobNumChips": "8", "jobMeshModel": "false"})
    fo = _flow_ops(tmp_path)
    fo.save_flow(gui)
    res = fo.generate_configs("mesh-optout")
    assert res.ok, res.errors
    assert "mesh.model" not in open(res.conf_paths[0]).read()


# ---------------------------------------------------------------------------
# the port's own cross-check
# ---------------------------------------------------------------------------
def test_latency_model_is_uncalibrated_without_a_profile():
    report = analyze_flow_mesh(load_flow("clean_config2_window_agg"), chips=4,
                               lower=False, spec=CPU)
    lm = report.latency_model()
    assert (lm["profileSource"], lm["iciGBps"], lm["totals"]["iciMs"]) == (
        "uncalibrated", None, None)
    assert not hasattr(meshcheck, "DEFAULT_PROFILE")
    wire = report.totals()["iciWireBytesPerBatch"]
    lm = report.latency_model({"ici_gbps": 100.0})
    assert lm["totals"]["iciMs"] == pytest.approx(round(wire / 100.0 / 1e6, 4))
    assert meshcheck.DEFAULT_MESH_CHIPS == 8


def test_lower_false_is_model_only_and_dx791_needs_a_flow_without_a_plan():
    flow = load_flow("clean_config2_window_agg")
    fast = analyze_flow_mesh(flow, chips=8, lower=False, spec=CPU)
    assert not fast.validated and fast.cross_check is None
    assert all(s.lowered_bytes is None for s in fast.stages)
    full = analyze_flow_mesh(flow, chips=8, spec=CPU)
    assert full.validated and "DX791" not in full.codes()
    # one chip is one virtual shard: no collective, the plan still held
    one = analyze_flow_mesh(flow, chips=1, spec=CPU)
    assert one.validated and one.errors == [] and one.cross_check.shards == 1
    for name in ("dx791_mesh_unavailable", "dx790_mesh_lowering"):
        report = analyze_flow_mesh(load_flow(name), chips=8, spec=CPU)
        assert not report.validated and report.stages == []


def _tampered(monkeypatch, change):
    real = meshcheck._infer_plan

    def infer(bundle, chips):
        stages, env = real(bundle, chips)
        change(stages)
        return stages, env

    monkeypatch.setattr(meshcheck, "_infer_plan", infer)


def test_a_gather_the_plan_lacks_is_dx790(monkeypatch):
    def drop(stages):
        agg = next(s for s in stages if s.kind == "group")
        agg.reshards.clear()

    _tampered(monkeypatch, drop)
    report = analyze_flow_mesh(load_flow("clean_config2_window_agg"), chips=8, spec=CPU)
    [d] = [d for d in report.diagnostics if d.code == "DX790"]
    assert d.table == "DataXProcessedInput_10seconds" and "lacks" in d.message
    assert not report.ok


def test_a_missing_gather_and_a_byte_mismatch_are_dx790(monkeypatch):
    def tamper(stages):
        agg = next(s for s in stages if s.kind == "group")
        agg.reshards[0].result_bytes += 4
        agg.reshards.append(meshcheck.ReshardEdge("DataXProcessedInput", 100, 700.0))

    _tampered(monkeypatch, tamper)
    report = analyze_flow_mesh(load_flow("clean_config2_window_agg"), chips=8, spec=CPU)
    messages = [d.message for d in report.diagnostics if d.code == "DX790"]
    assert len(messages) == 2
    assert any("made no such all-gather" in m for m in messages)
    assert any("closed form says" in m for m in messages)


def test_a_step_that_raises_is_dx790(monkeypatch):
    from data_accelerator_tpu_torch.runtime import processor

    def broken(*_a, **_k):
        raise RuntimeError("shard out of range")

    monkeypatch.setattr(processor, "build_mesh_step_fn", broken)
    report = analyze_flow_mesh(load_flow("clean_config2_window_agg"), chips=8, spec=CPU)
    [d] = [d for d in report.diagnostics if d.code == "DX790"]
    assert "shard out of range" in d.message and report.validated


def test_a_table_gathered_at_two_stages_is_one_census_gather():
    """DX701's repeat is the model's price: the step shares one gather
    of the window between its two grouped consumers, and the cross-check
    holds that one gather against both reshard edges."""
    report = analyze_flow_mesh(load_flow("dx701_repeated_reshard"), chips=8, spec=CPU)
    assert report.codes() == ["DX701", "DX705"] and report.validated
    edges = report.cross_check.edges
    assert [e["stage"] for e in edges] == ["Counts", "Peaks"]
    assert {e["table"] for e in edges} == {"DataXProcessedInput_4seconds"}
    assert all(e["censusBytes"] == e["modelBytes"] for e in edges)
    assert report.cross_check.census["all-gather"] == {
        "count": 1, "resultBytes": edges[0]["modelBytes"]}
    assert report.totals()["reshardCount"] == 2
    for s in report.stages:
        assert s.lowered_bytes == s.ici_result_bytes


def test_a_table_the_step_gathers_twice_is_dx790(monkeypatch):
    from data_accelerator_tpu_torch.dist import mesh as dmesh

    real = dmesh.MeshCollectives.record

    def twice(self, op, result_bytes, table=""):
        real(self, op, result_bytes, table)
        if op == "all-gather":
            real(self, op, result_bytes, table)

    monkeypatch.setattr(dmesh.MeshCollectives, "record", twice)
    report = analyze_flow_mesh(load_flow("clean_config2_window_agg"), chips=8, spec=CPU)
    [d] = [d for d in report.diagnostics if d.code == "DX790"]
    assert d.table == "DataXProcessedInput_10seconds" and "2 times" in d.message


def _emulate_card(monkeypatch, memory: int):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: type("Props", (), {"total_memory": memory}))


def test_default_spec_is_the_machines_cards(monkeypatch):
    """Without ``spec=`` the per-chip budget is ``FleetSpec()``'s, the
    machine's cards, whatever device the cross-check runs on: DX702
    follows the card's memory, and without a card the tier raises."""
    flow = load_flow("dx702_perchip_hbm")
    seen = []
    real = meshcheck._lint

    def lint(bundle, stages, chips, spec, jobconf, diags):
        seen.append(spec)
        real(bundle, stages, chips, spec, jobconf, diags)

    monkeypatch.setattr(meshcheck, "_lint", lint)
    _emulate_card(monkeypatch, 1 << 20)
    assert "DX702" in analyze_flow_mesh(flow, chips=8, lower=False).codes()
    assert seen[-1].hbm_per_chip_bytes == FleetSpec().hbm_per_chip_bytes == 1 << 20
    _emulate_card(monkeypatch, 80 * 10 ** 9)
    assert "DX702" not in analyze_flow_mesh(flow, chips=8, lower=False).codes()
    assert seen[-1].hbm_per_chip_bytes == FleetSpec().hbm_per_chip_bytes
    assert seen[-1].headroom_fraction == FleetSpec().headroom_fraction
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_flow_mesh(flow, chips=8, lower=False)


def test_cli_and_rest_mesh_read_the_fleet_spec(tmp_path, capsys, monkeypatch):
    """``--mesh`` takes ``--fleet-spec``/``--fleet-device`` as ``--fleet``
    does, and exits 2 without a card and without them; REST takes
    ``fleetSpec``. A 1 KiB chip makes the DX702 fixture's twin an error
    on both surfaces alike."""
    import torch

    [path] = _port_files(tmp_path, ["dx702_perchip_hbm_clean"])
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"hbmPerChipBytes": 1024}))
    rc, out, _ = _run_cli(["--mesh", "--fleet-device=cpu", path], capsys)
    assert rc == 0 and "DX702" not in out
    rc, out, err = _run_cli(
        ["--mesh", f"--fleet-spec={spec}", "--fleet-device=cpu", "--json", path], capsys)
    assert rc == 1, err
    cli_report = json.loads(out)
    assert "DX702" in [d["code"] for d in cli_report["diagnostics"]]
    api = _api(tmp_path)
    try:
        status, res = api.dispatch("POST", "api/flow/validate", body={
            "flow": load_flow("dx702_perchip_hbm_clean"), "mesh": True,
            "fleetSpec": {"hbmPerChipBytes": 1024}})
    finally:
        api.livequery.stop()
    assert status == 200
    assert res["result"]["diagnostics"] == cli_report["diagnostics"]
    assert res["result"]["mesh"] == cli_report["mesh"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _o, err = _run_cli(["--mesh", path], capsys)
    assert rc == 2 and "--mesh: cannot read fleet spec" in err


def test_host_over_virtual_shards_reads_census_over_model(tmp_path):
    """A generated 4-chip conf on a host over 4 CPU virtual shards: the
    monitor's ``Conformance_MeshIci_Ratio`` is the census's wire bytes
    over the model's within 1e-6, DX510/511 stay silent; the same conf
    with the model's wire bytes cut 16-fold fires DX510 once."""
    from data_accelerator_tpu_torch.core.confmanager import ConfigManager
    from data_accelerator_tpu_torch.runtime.host import StreamingHost
    from data_accelerator_tpu_torch.serve.scenarios import probe_deploy_gui
    from test_torch_conformance import CaptureWriter

    gui = probe_deploy_gui("mesh-host")
    gui["process"]["jobconfig"] = {"jobNumChips": "4", "jobBatchCapacity": "1024"}
    fo = _flow_ops(tmp_path)
    fo.save_flow(gui)
    res = fo.generate_configs("mesh-host")
    assert res.ok, res.errors
    model = json.loads(_conf_dict(res.conf_paths[0])["datax.job.process.mesh.model"])
    wire = model["totals"]["iciWireBytesPerBatch"]
    assert wire > 0

    def run(overrides):
        ConfigManager.reset()
        ConfigManager.get_configuration_from_arguments([f"conf={res.conf_paths[0]}"])
        conf = ConfigManager.load_config().with_settings(
            {"datax.job.process.conformance.warmup": "1", **overrides})
        host = StreamingHost(conf, device="cpu", mesh=make_mesh(4, devices=("cpu",) * 4))
        cap = CaptureWriter()
        host.telemetry.writers.append(cap)
        try:
            host.run(max_batches=4)
        finally:
            host.stop()
            ConfigManager.reset()
        drift = [r["properties"]["code"] for r in cap.records
                 if r.get("type") == "event" and r["name"] == "conformance/drift"]
        points = lambda m: [p["val"] for p in host.metric_logger.store.points(  # noqa: E731
            f"DATAX-mesh-host:{m}")]
        return host, drift, points

    host, drift, points = run({})
    assert host.processor.mesh.size == 4
    census = host.processor.mesh_collectives
    ici = points("Mesh_ICI_Bytes")
    assert ici and set(ici) == {census.wire_bytes(4)}
    assert census.to_dict()["all-gather"]["resultBytes"] == model["totals"][
        "iciResultBytesPerBatch"]
    ratios = points("Conformance_MeshIci_Ratio")
    assert ratios and all(abs(r - census.wire_bytes(4) / wire) < 1e-6 for r in ratios)
    assert not {"DX510", "DX511"} & set(drift)

    cut = dict(model, totals=dict(model["totals"], iciWireBytesPerBatch=wire / 16))
    _host, drift, _points = run({"datax.job.process.mesh.model": json.dumps(cut)})
    assert drift.count("DX510") == 1 and "DX511" not in drift


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
def test_cross_check_on_the_card_equals_the_model(card):
    """The census cross-check with the mesh step on 4 virtual shards of
    the card: every clean and shipped flow validates, census equal to
    the model gather by gather, and the report equals the ``meta`` one
    but for the cross-check's device."""
    import torch

    from data_accelerator_tpu_torch.obs.calibrate import ici_probe

    for name, flow in _self_lint_flows():
        report = analyze_flow_mesh(flow, chips=4, device=card)
        assert report.errors == [] and report.validated, name
        for s in report.stages:
            assert s.lowered_bytes == s.ici_result_bytes, (name, s.name)
        on_meta = analyze_flow_mesh(flow, chips=4).mesh_dict()
        on_card = report.mesh_dict()
        assert on_card["crossCheck"].pop("device") == card
        on_meta["crossCheck"].pop("device")
        assert on_card == on_meta, name
    gbps, how = ici_probe(card)
    assert (gbps is None) == (torch.cuda.device_count() < 2), how
