"""A later cell, traffic mix or per-layer metric is new files and new
``BENCHMARK.json`` entries: the harness finds them by name, and no file
that is there changes."""

import hashlib
import json
import shutil
import subprocess
import sys

from streambench import harness


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
