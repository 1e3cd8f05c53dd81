"""The port's conf tier (``analysis/confcheck.py``, DX1000-DX1005) and its
registry of engine-emitted metric names, against the JAX package's
(``tests/test_confcheck.py``).

- Every golden twin under ``tests/data/conf/`` (modules and concrete
  confs) gives the same diagnostics in both tiers; so does the seeded
  designer-chain break, scanned from a copy of the reference's
  ``serve/generation.py`` (the port has no generation module until
  slice 9).
- The standing gate: the port's full tree gives no DX10xx, with its
  inventory pinned.
- The registry: every row's type, default and bounds equal the
  reference's; the three rows nothing in the port reads are
  ``read=False`` (pinned by name; ``conformance.iciratiohigh`` is read
  since the mesh tier came), and the boot audit's ``Conf_*``
  gauges stay the JAX host's.
- ``MetricName.RUNTIME_METRIC_PATTERNS``/``is_runtime_metric`` equal the
  reference's and cover the port's families.
"""

import dataclasses
import glob
import json
import os

import pytest

from data_accelerator_tpu.analysis import confcheck as jconf
from data_accelerator_tpu.analysis import confspec as jspec
from data_accelerator_tpu.constants import MetricName as JMetricName
from data_accelerator_tpu.runtime.confaudit import audit_conf as jaudit_conf
from data_accelerator_tpu_torch.analysis import confcheck as tconf
from data_accelerator_tpu_torch.analysis import confspec as tspec
from data_accelerator_tpu_torch.analysis.__main__ import main as port_main
from data_accelerator_tpu_torch.constants import MetricName
from data_accelerator_tpu_torch.runtime.confaudit import audit_conf

HERE = os.path.dirname(__file__)
CONF_DIR = os.path.join(HERE, "data", "conf")
FLOWS_DIR = os.path.join(HERE, "data", "flows")
GENERATION = os.path.join(os.path.dirname(HERE), "data_accelerator_tpu", "serve",
                          "generation.py")
TWINS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONF_DIR, "dx*")))
# the row the reference reads and the port does not (the JAX package's
# transfer-helper jit cache): read=False in the port
PORT_UNREAD = {"compile.jitcachecap"}


def _diags(report):
    return [(d.code, d.severity, d.span.line, d.table, d.message)
            for d in report.diagnostics]


def test_every_code_has_its_twins():
    assert len(TWINS) == 12


@pytest.mark.parametrize("name", TWINS)
def test_golden_twin_diagnostics_equal_reference(name):
    path = os.path.join(CONF_DIR, name)
    jr, tr = jconf.analyze_conf_modules([path]), tconf.analyze_conf_modules([path])
    assert _diags(tr) == _diags(jr)
    assert tr.ok == jr.ok
    assert ("_clean." in name) == (tr.diagnostics == [])
    assert tr.conf_dict() == jr.conf_dict()


def test_seeded_chain_break_equals_reference(tmp_path):
    """The reference's generation module with one S650 key renamed:
    both tiers give the same DX1001 and DX1002 findings."""
    src = open(GENERATION, encoding="utf-8").read()
    seeded = src.replace('"datax.job.process.ingest.decoderthreads"',
                         '"datax.job.process.ingest.decoderthread"')
    assert seeded != src
    path = tmp_path / "generation.py"
    path.write_text(seeded)
    jr, tr = jconf.analyze_conf_modules([str(path)]), tconf.analyze_conf_modules([str(path)])
    assert _diags(tr) == _diags(jr)
    assert {d.code for d in tr.diagnostics} == {"DX1001", "DX1002"}
    assert any("jobDecoderThreads" in d.message for d in tr.diagnostics)


def test_port_tree_is_conf_clean_with_pinned_inventory():
    paths = tconf.conf_module_paths()
    assert all("data_accelerator_tpu_torch" in p for p in paths)
    report = tconf.analyze_conf_modules(paths)
    assert report.diagnostics == [], [d.render() for d in report.diagnostics]
    cd = report.conf_dict()
    # native/jsonl.py, the blob sink's renderer, reads no conf key
    assert cd["analyzedFiles"] == len(paths) == 95
    # obs/conformance.py reads conformance.iciratiohigh (DX510), and
    # runtime/processor.py compile.cachedir and compile.cacheurl
    assert cd["readSites"] == 102
    assert cd["readKeys"] == 96
    # the flattener template's keys, the control plane's generation scan
    # (serve/generation.py; its S400 knob tokens too), the REST API's
    # UDF class keys for a flow's kernels (serve/restapi.py) and the
    # chaos drills' host confs (serve/scenarios.py); S660 adds mesh.model
    assert cd["producedKeys"] == 54
    assert cd["knobTokens"] == 6
    assert cd["registryKeys"] == len(tspec.CONF_REGISTRY) == 109


def test_reference_tier_flags_only_the_row_the_port_does_not_read():
    """The reference's full-tree registry check over the port's tree
    with the reference's rows: only the row the port deliberately
    leaves unread is dead; the two debug reads and the compile cache's
    two keys are seen."""
    scans = []
    paths = tconf.conf_module_paths()
    for p in paths:
        s = jconf._ModuleConfScan(p)
        if s.run():
            scans.append(s)
    # the gate's own rule: the chain checks run with generation in scope
    chain_scope = any(os.path.basename(p) == "generation.py" for p in paths)
    assert chain_scope
    diags = []
    jconf._check_lattice(scans, diags, full_tree=True, chain_scope=chain_scope)
    dead = {d.message.split("'")[1].removeprefix(jspec.PROCESS_PREFIX)
            for d in diags if d.code == "DX1001"}
    assert dead == PORT_UNREAD
    assert {d.code for d in diags} == {"DX1001"}


def test_registry_rows_equal_the_reference_but_for_the_unread_jit_cache_cap():
    assert [e.key for e in tspec.CONF_REGISTRY] == [e.key for e in jspec.CONF_REGISTRY]
    for t, j in zip(tspec.CONF_REGISTRY, jspec.CONF_REGISTRY):
        t, j = dataclasses.asdict(t), dataclasses.asdict(j)
        if t["key"] in PORT_UNREAD:
            assert j["read"] and not t["read"]
            assert dict(t, read=True) == j
        else:
            assert t == j
    parity = [e for e in tspec.CONF_REGISTRY if not e.read]
    assert len(parity) == 6
    assert {e.key for e in parity} - PORT_UNREAD == {
        e.key for e in jspec.CONF_REGISTRY if not e.read}


@pytest.mark.parametrize("conf", [
    {"datax.job.process.batchcapacity": "8"},
    {"datax.job.process.compile.jitcachecap": "0",
     "datax.job.process.compile.cachedir": "/tmp/x",
     "datax.job.process.mesh.observe": "maybe",
     "datax.job.process.conformance.iciratiohigh": "-1",
     "datax.job.process.bogus": "1"},
])
def test_conf_audit_gauges_equal_the_reference(conf):
    t, j = audit_conf(conf), jaudit_conf(conf)
    assert t.metric_deltas() == j.metric_deltas()
    assert [(e["key"], e["reason"]) for e in t.events()] == \
        [(e["key"], e["reason"]) for e in j.events()]


def test_runtime_metric_registry_equals_the_reference():
    # the reference's registry, then the port's own names
    assert MetricName.RUNTIME_METRIC_PATTERNS == \
        JMetricName.RUNTIME_METRIC_PATTERNS + MetricName.PORT_RUNTIME_METRIC_PATTERNS
    assert MetricName.PORT_RUNTIME_METRIC_PATTERNS == (
        "Sink_file_ColumnarRows", "Group_RowsScanned", "Group_RowsInWindow", "Group_Count")
    assert MetricName.is_runtime_metric("Sink_file_ColumnarRows")
    assert not MetricName.is_runtime_metric("Sink_kafka_ColumnarRows")
    assert not JMetricName.is_runtime_metric("Sink_file_ColumnarRows")
    for name in (MetricName.CONF_AUDITED, MetricName.CONF_UNKNOWN,
                 MetricName.CONF_OUT_OF_BOUNDS, *MetricName.STATE_METRICS,
                 MetricName.FLEET_FRAMES, "Sanitizer_PoisonHit_Count",
                 "Calib_DispatchOverheadUs", "Compile_WarmMiss_Count"):
        assert MetricName.is_runtime_metric(name), name
    assert not MetricName.is_runtime_metric("Bogus_Count")


def test_flow_conf_gate_equals_reference_on_shipped_flows():
    for path in sorted(glob.glob(os.path.join(FLOWS_DIR, "*.json"))):
        with open(path) as f:
            flow = json.load(f)
        t = tconf.analyze_flow_conf(flow)
        j = jconf.analyze_flow_conf(flow)
        # the per-flow half (DX1004/DX1005) over the same registry
        per_flow = lambda r: [x for x in _diags(r) if x[0] in ("DX1004", "DX1005")]  # noqa: E731
        assert per_flow(t) == per_flow(j), path
        if os.path.basename(path).startswith("clean_"):
            assert t.diagnostics == [], path


def test_cli_conf_exit_and_json(capsys):
    flow = os.path.join(FLOWS_DIR, "clean_config2_window_agg.json")
    assert port_main(["--conf", flow]) == 0
    assert "conf gate:" in capsys.readouterr().out
    assert port_main(["--conf", "--json", flow]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["conf"]["registryKeys"] == 109
