"""A later cell, traffic mix or per-layer metric is new files and new
``BENCHMARK.json`` entries: the harness finds them by name, and no file
that is there changes. That holds for a streaming deployment with a
second socket source, judged by a plain-PyTorch reference, too."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from streambench import harness
from test_streambench_imports import reference_faults


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    tree = tmp_path / "streambench"
    shutil.copytree(harness.HERE, tree,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = _digests(tree)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    # new files only
    mix = harness.load_json(tree / "traffic" / "calm.json")
    mix["door_share"] = 0.2
    (tree / "traffic" / "door_heavy.json").write_text(json.dumps(mix))
    (tree / "workloads" / "iot_alerts.door_heavy.json").write_text(json.dumps({
        "config": "iot_alerts", "traffic": "door_heavy", "loop": "stream",
        "rate": 1000, "fill_batches": 6, "why": "a test cell"}))
    (tree / "metrics" / "rows_a_batch.stream.py").write_text(
        "def read(record):\n    return record['rows'] / record['batches']\n")
    # new entries only
    bench["workloads"].append({"name": "iot_alerts.door_heavy", "config": "iot_alerts",
                               "traffic": "door_heavy", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "iot_alerts.calm" in m.get("workloads", []):
            m["workloads"].append("iot_alerts.door_heavy")
    bench["per_layer"].append({
        "name": "rows_a_batch.stream", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "ingest", "moves": "latency_p95_ms",
        "workloads": ["iot_alerts.door_heavy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from streambench import harness\n"
        "c = harness.find_cell('iot_alerts.door_heavy', 5, 1.0, True)\n"
        "from streambench.traffic import generator\n"
        "ev = generator.events(c.mix, 5, 10000)\n"
        "m = harness.load_module('metrics', 'rows_a_batch.stream')\n"
        "print(json.dumps({'e2e': [x['name'] for x in c.end_to_end()],\n"
        "  'layer': [x['name'] for x in c.per_layer()],\n"
        "  'door': float((ev['type'] == generator.DOOR).mean()),\n"
        "  'read': m.read({'rows': 30, 'batches': 3}),\n"
        "  'here': str(harness.HERE)}))\n"
    )
    p = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.splitlines()[-1])
    assert got["here"] == str(tree)
    assert set(got["e2e"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert got["layer"] == ["rows_a_batch.stream"]
    assert 0.18 < got["door"] < 0.22 and got["read"] == 10
    after = _digests(tree)
    assert {k: after[k] for k in before} == before


# the proof of room for a two-source cell: new files only
PROOF_CONFIG, PROOF_MIX = "iot_readings", "storm_readings"
PROOF_CELL = f"{PROOF_CONFIG}.{PROOF_MIX}"
WEATHER_SCHEMA = {"type": "struct", "fields": [
    {"name": "stationId", "type": "long", "nullable": False,
     "metadata": {"allowedValues": [150, 32, 88]}},
    {"name": "windSpeed", "type": "double", "nullable": False,
     "metadata": {"minValue": 0, "maxValue": 120}}]}
WEATHER_CONF = """\
datax.job.input.sources.weather.inputtype=socket
datax.job.input.sources.weather.socket.port=0
datax.job.input.sources.weather.blobschemafile=@CONF@/weatherschema.json
datax.job.input.sources.weather.target=Weather
datax.job.input.sources.weather.projection=@CONF@/weather.projection
datax.job.input.sources.weather.streaming.maxbatchsize=1024
datax.job.output.Readings.metric=enabled
"""
PROOF_REFERENCE = '''"""The plain reference of ``iot_readings``: ``iot_alerts``'s rules over
the primary stream, and every weather reading a batch consumed landed
as one ``Readings`` row, its wind speed the float32 of the text, exactly;
in plain PyTorch on the CPU."""

from collections import Counter

import torch

from streambench.reference import iot, iot_alerts
from streambench.traffic import generator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def readings(cell, record, dtype):
    """Per batch, the multiset of (station, wind speed) it consumed."""
    spec = cell.mix["streams"]["weather"]
    n = max((r["sources"]["weather"][1] for r in record["framing"]), default=0)
    cols = generator.readings(spec, cell.seed, "weather", n)
    milli = torch.tensor(cols["value_milli"].tolist(), dtype=torch.float64, device="cpu")
    wind = (milli / 1000).to(dtype).to(torch.float64).tolist()
    keys = cols["key"].tolist()
    return [Counter((keys[i], wind[i]) for i in range(*r["sources"]["weather"]))
            for r in record["framing"]]


def judge(cell, record, outputs=None):
    got = record["outputs"] if outputs is None else outputs
    v = iot_alerts.judge(cell, record, outputs)
    wrong = 0
    for r, want in zip(record["framing"], readings(cell, record, torch.float32)):
        have = Counter((int(x["stationId"]), float(x["windSpeed"]))
                       for x in got["Readings"].get(r["bt"], []))
        wrong += sum(((have - want) + (want - have)).values())
    checks = dict(v["checks"], readings_wrong={"value": wrong, "limit": 0})
    return dict(iot.verdict(checks), lines=v["lines"])


def control_outputs(cell, record):
    out = iot_alerts.control_outputs(cell, record)
    out["Readings"] = {
        r["bt"]: [{"stationId": k, "windSpeed": w} for (k, w), c in want.items()
                  for _ in range(c)]
        for r, want in zip(record["framing"], readings(cell, record, torch.bfloat16))}
    return out
'''
PROBE = """\
import json, sys
sys.path[:0] = [{tree!r}, {root!r}]
from streambench import harness
from data_accelerator_tpu_torch.obs.store import METRIC_STORE
from data_accelerator_tpu_torch.runtime import sources

harness.set_cache_env()
poll_raw = sources.SocketSource.poll_raw


def starved(self, max_events):
    return poll_raw(self, 0 if self.name == "weather.socket" else max_events)


out = {{}}
for variant in ("program", "control", "starved"):
    sources.SocketSource.poll_raw = starved if variant == "starved" else poll_raw
    METRIC_STORE.clear()
    cell = harness.find_cell({cell!r}, {seed}, {seconds}, False)
    loop = harness.load_module("loops", cell.workload["loop"])
    if {device!r} == "cpu":
        loop.shrink(cell)
    traffic = loop.start_traffic(cell)
    try:
        res, lines = harness.run_cell(cell, {device!r}, traffic, control=variant == "control")
    finally:
        loop.stop_traffic(traffic)
    out[variant] = dict(res, lines=lines)
print(json.dumps(out))
"""


def _proof_tree(tmp_path):
    """A copy of the benchmark with a two-source cell added as new files
    and new ``BENCHMARK.json`` entries only."""
    tree = tmp_path / "streambench"
    shutil.copytree(harness.HERE, tree,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = _digests(tree)
    conf_dir = tree / "configs" / PROOF_CONFIG
    shutil.copytree(tree / "configs" / "iot_alerts", conf_dir)
    for name in ("config.json", "iot_alerts.conf", "iot_alerts.transform"):
        (conf_dir / name).unlink()
    src = harness.HERE / "configs" / "iot_alerts"
    config = harness.load_json(src / "config.json")
    config.update(name=PROOF_CONFIG, conf=f"{PROOF_CONFIG}.conf",
                  outputs=dict(config["outputs"], Readings="metric"))
    (conf_dir / "config.json").write_text(json.dumps(config))
    (conf_dir / f"{PROOF_CONFIG}.conf").write_text(
        (src / "iot_alerts.conf").read_text().replace(
            "iot_alerts.transform", f"{PROOF_CONFIG}.transform") + WEATHER_CONF)
    (conf_dir / f"{PROOF_CONFIG}.transform").write_text(
        (src / "iot_alerts.transform").read_text()
        + "--DataXQuery--\nReadings = SELECT stationId, windSpeed FROM Weather\n")
    (conf_dir / "weatherschema.json").write_text(json.dumps(WEATHER_SCHEMA))
    (conf_dir / "weather.projection").write_text("current_timestamp() AS eventTimeStamp\nRaw.*")
    mix = harness.load_json(tree / "traffic" / "calm.json")
    mix.update(home_id=[150, 32, 88], streams={"weather": {
        "kind": "readings", "key_field": "stationId", "value_field": "windSpeed",
        "keys": [150, 32, 88], "period_s": 5, "offset_s": [0, 1, 2],
        "value": [[50.001, 120], [0, 50], [0, 50]]}})
    (tree / "traffic" / f"{PROOF_MIX}.json").write_text(json.dumps(mix))
    (tree / "workloads" / f"{PROOF_CELL}.json").write_text(json.dumps({
        "config": PROOF_CONFIG, "traffic": PROOF_MIX, "loop": "stream",
        "rate": 20000, "fill_batches": 6, "why": "a test cell"}))
    (tree / "reference" / f"{PROOF_CONFIG}.py").write_text(PROOF_REFERENCE)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": PROOF_CONFIG, "source": config["source"],
                             "file": f"streambench/configs/{PROOF_CONFIG}/config.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": PROOF_CELL, "config": PROOF_CONFIG,
                               "traffic": PROOF_MIX, "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "iot_alerts.calm" in m.get("workloads", []):
            m["workloads"].append(PROOF_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tree, before


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_two_source_cell_with_a_plain_pytorch_reference_is_new_files_only(
        tmp_path, request, device):
    if device == "cuda":
        request.getfixturevalue("card")
    tree, before = _proof_tree(tmp_path)
    assert reference_faults(tmp_path, tree / "reference" / f"{PROOF_CONFIG}.py") == []
    (tmp_path / "tmp").mkdir()
    probe = PROBE.format(tree=str(tmp_path), root=str(harness.ROOT), cell=PROOF_CELL,
                         seed=2**31 + 23, seconds=2.0 if device == "cpu" else 4.0,
                         device=device)
    p = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                       env=dict(__import__("os").environ, TMPDIR=str(tmp_path / "tmp")),
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.splitlines()[-1])
    prog, ctl, starved = got["program"], got["control"], got["starved"]
    assert prog["correct"], prog["checks"]
    side = json.loads(prog["lines"][0])
    weather = side["side_streams"]["weather"]
    # the readings due in the window are among those attempted, and acked
    assert weather["total"] - weather["open"] >= 1 and weather["lost"] == 0
    assert prog["attempted"] == side["window_events"] + weather["total"] - weather["open"]
    assert prog["checks"]["readings_wrong"]["value"] == 0
    assert not ctl["correct"] and ctl["checks"]["readings_wrong"]["value"] > 0
    assert not starved["correct"] and starved["failed"] > 0
    after = _digests(tree)
    assert {k: after[k] for k in before} == before
