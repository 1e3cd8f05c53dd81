"""``BENCHMARK.json`` keeps the benchmark's contract: names and units of
the allowed characters, the keys each entry may have, every name found
as a file, every cell on one chip reporting ``setup_s``, another
end-to-end metric and a per-layer one."""

import json
import re

import pytest

from streambench.harness import HERE, ROOT, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["streambench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entry_keys_names_and_texts(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_configs_and_workloads_are_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("streambench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        f = load_json(HERE / "workloads" / f"{w['name']}.json")
        assert (f["config"], f["traffic"]) == (w["config"], w["traffic"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "loops" / f"{f['loop']}.py").is_file()
        assert (HERE / "reference" / f"{w['config']}.py").is_file()
    assert configs == {w["config"] for w in BENCH["workloads"]}


def test_metrics_have_readers_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        suffix = m["name"].rsplit(".", 1)[-1]
        assert m["moves"] == {"stream": "latency_p95_ms", "batch": "events_per_s"}[suffix]
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"loop", "source", "ingest", "processor", "kernels", "landing", "device"}


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if p.is_file() and ".cache" not in p.parts and "__pycache__" not in p.parts:
            rel = str(p.relative_to(ROOT))
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_benchmark_json_is_plain_json():
    json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
