"""The port's fleet tier (``analysis/fleetcheck.py``, DX400-DX413) against
the JAX package's (``tests/test_fleetcheck.py``).

The two plans price flows differently (config 1's ``hbmBytes`` is
144,388,096 in the port, 133,902,336 in the JAX package), so each
fixture of ``tests/data/fleets/`` goes through both tiers with one
explicit ``FleetSpec`` and one set of footprints:

- placement and every diagnostic (code, severity, subject, message) are
  equal on the JAX tier's footprints handed to both;
- the resources each flow claims (directories, consumer groups, metric
  series, observability port) are equal, so the interference lints
  (DX410-DX413) are equal on the golden fleets and flows;
- the port's own footprints place the same flows on the same cards.

The deliberate difference: a spec's unset chip count and memory are
the machine's (the cards present and a card's total memory, or
``CPU_DEVICE_MEMORY_BYTES`` on the CPU), never a TPU's 16 GiB.
"""

import dataclasses
import json
import os

import pytest

from data_accelerator_tpu.analysis import fleetcheck as jfleet
from data_accelerator_tpu_torch.analysis import fleetcheck as tfleet
from data_accelerator_tpu_torch.analysis.__main__ import main as port_main
from data_accelerator_tpu_torch.analysis.diagnostics import Diagnostic, Span
from data_accelerator_tpu_torch.constants import CPU_DEVICE_MEMORY_BYTES

HERE = os.path.dirname(__file__)
FLEETS_DIR = os.path.join(HERE, "data", "fleets")
FLOWS_DIR = os.path.join(HERE, "data", "flows")
FIXTURES = sorted(f[:-5] for f in os.listdir(FLEETS_DIR) if f.endswith(".json"))
RESOURCES = ("dirs", "consumer_keys", "metric_series", "obs_port", "chips_required",
             "interval_s")


def _to_port(text: str) -> str:
    """A flow's UDF module paths pointed at the port's fixtures."""
    return (text.replace("tests.data.udfs.", "tests.data.udfs_torch.")
            .replace("dx305_pallas", "dx305_cuda")
            .replace("data_accelerator_tpu.udf.samples",
                     "data_accelerator_tpu_torch.udf.samples"))


def _load(name):
    with open(os.path.join(FLEETS_DIR, name + ".json")) as f:
        return json.load(f)


def _specs(doc):
    """One explicit spec, every field set, for both tiers."""
    jspec = jfleet.FleetSpec.from_dict(doc["fleetSpec"])
    return jspec, tfleet.FleetSpec.from_dict(jspec.to_dict(), device="cpu")


def _port_footprint(jfp):
    d = {f.name: getattr(jfp, f.name) for f in dataclasses.fields(jfp)}
    d["diagnostics"] = [Diagnostic(x.code, x.severity, x.table, x.message,
                                   Span(line=x.span.line)) for x in jfp.diagnostics]
    return tfleet.FlowFootprint(**d)


def _diags(report):
    return [(d.code, d.severity, d.table, d.message) for d in report.diagnostics]


@pytest.mark.parametrize("name", FIXTURES)
def test_placement_and_diagnostics_equal_on_given_footprints(name):
    doc = _load(name)
    jspec, tspec = _specs(doc)
    jfps = [jfleet.flow_footprint(f) for f in doc["flows"]]
    jr = jfleet.analyze_fleet(jfps, jspec)
    tr = tfleet.analyze_fleet([_port_footprint(fp) for fp in jfps], tspec)
    assert _diags(tr) == _diags(jr)
    assert tr.ok == jr.ok
    assert tr.fleet_dict() == jr.fleet_dict()


@pytest.mark.parametrize("name", FIXTURES)
def test_claimed_resources_and_interference_lints_equal(name):
    doc = _load(name)
    jspec, tspec = _specs(doc)
    for flow in doc["flows"]:
        jfp, tfp = jfleet.flow_footprint(flow), tfleet.flow_footprint(flow)
        for attr in RESOURCES:
            assert getattr(tfp, attr) == getattr(jfp, attr), (name, attr)
    # the port's own footprints: the interference findings are the
    # reference's (capacity depends on each plan's bytes)
    jr = jfleet.analyze_fleet_flows(doc["flows"], jspec)
    tr = tfleet.analyze_fleet_flows(doc["flows"], tspec)
    inter = lambda r: [x for x in _diags(r) if x[0] >= "DX410"]  # noqa: E731
    assert inter(tr) == inter(jr)
    if name.endswith("_clean"):
        assert tr.diagnostics == [] and tr.placement.feasible


def test_shipped_flows_place_cleanly_on_one_cpu_device():
    flows = []
    for f in sorted(os.listdir(FLOWS_DIR)):
        if f.startswith("clean_") and f.endswith(".json"):
            with open(os.path.join(FLOWS_DIR, f)) as fh:
                flows.append(json.loads(_to_port(fh.read())))
    spec = tfleet.FleetSpec(device="cpu")
    report = tfleet.analyze_fleet_flows(flows, spec)
    assert report.ok and report.placement.feasible
    assert spec.chips == 1 and spec.hbm_per_chip_bytes == CPU_DEVICE_MEMORY_BYTES
    footprints = {fp.name: fp for fp in report.footprints}
    from data_accelerator_tpu_torch.analysis.deviceplan import analyze_flow_device

    for flow in flows:
        fp = footprints[flow.get("name")]
        assert fp.hbm_bytes == analyze_flow_device(flow).totals()["hbmBytes"]


def test_the_default_spec_is_the_machines_not_a_tpus():
    """Pinned difference: no 16 GiB TPU chip, no 8-chip slice; on a
    machine without a card the default spec of a card raises."""
    assert jfleet.DEFAULT_HBM_PER_CHIP == 16 * 1024 ** 3
    assert not hasattr(tfleet, "DEFAULT_HBM_PER_CHIP")
    assert not hasattr(tfleet, "DEFAULT_FLEET_CHIPS")
    cpu = tfleet.FleetSpec.from_dict({}, device="cpu")
    assert (cpu.chips, cpu.hbm_per_chip_bytes) == (1, CPU_DEVICE_MEMORY_BYTES)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfleet.FleetSpec()


@pytest.mark.parametrize("chips", [2, 8])
def test_multi_card_flow_waits_for_the_mesh(chips):
    """A flow that declares more than one card is placed at its chip
    count, as in the JAX package: its footprint is the port's plan at
    ``chips`` (no DX291), and its ICI bytes equal the reference's."""
    from data_accelerator_tpu_torch.analysis import analyze_flow_device

    with open(os.path.join(FLOWS_DIR, "clean_config2_window_agg.json")) as f:
        flow = json.load(f)
    flow.setdefault("process", {}).setdefault("jobconfig", {})["jobNumChips"] = str(chips)
    fp = tfleet.flow_footprint(flow)
    jfp = jfleet.flow_footprint(flow)
    assert fp.chips_required == jfp.chips_required == chips
    assert fp.diagnostics == [] and jfp.diagnostics == []
    totals = analyze_flow_device(flow, chips=chips).totals()
    assert fp.hbm_bytes == totals["hbmBytes"]
    assert fp.ici_bytes_per_batch == jfp.ici_bytes_per_batch > 0


def test_cli_fleet_with_a_spec_file(tmp_path, capsys):
    doc = _load("dx400_oversubscribed")
    paths = []
    for i, flow in enumerate(doc["flows"]):
        p = tmp_path / f"f{i}.json"
        p.write_text(json.dumps(flow))
        paths.append(str(p))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(doc["fleetSpec"]))
    rc = port_main(["--fleet", f"--fleet-spec={spec}", "--fleet-device=cpu",
                    "--json", *paths])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 1 and "DX400" in {d["code"] for d in rep["diagnostics"]}
    assert rep["fleet"]["spec"]["hbmPerChipBytes"] == doc["fleetSpec"]["hbmPerChipBytes"]
