"""A tiny CPU rehearsal of each cell of ``BENCHMARK.json``, at the size
its loop's ``shrink`` gives, through the harness's internal
``device="cpu"`` hook (the command itself still needs a card), the
control that has to come out not correct, and the program broken
underneath in each way a cell can be: its state left unchanged, half
of each batch left out, an answer altered where it is produced. (No
cell spans chips, so none can leave out an exchange between them.)"""

import os
import shutil
import subprocess
import sys

import pytest

from streambench import harness

SEED = 2**31 + 3


@pytest.fixture(autouse=True)
def _caches(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    harness.set_cache_env()


def _cell(name, seconds=2.0, trace=False):
    cell = harness.find_cell(name, SEED, seconds, trace)
    harness.load_module("loops", cell.workload["loop"]).shrink(cell)
    return cell


def _run(cell, control=False):
    from data_accelerator_tpu_torch.obs.store import METRIC_STORE

    METRIC_STORE.clear()
    loop = harness.load_module("loops", cell.workload["loop"])
    traffic = loop.start_traffic(cell)
    try:
        return harness.run_cell(cell, "cpu", traffic, control=control)[0]
    finally:
        loop.stop_traffic(traffic)
        shutil.rmtree(cell.tmp, ignore_errors=True)


# every cell of BENCHMARK.json, found there
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_rehearses_correct_on_the_cpu(name):
    res = _run(_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "cpu"
    want = {m["name"] for m in harness.load_json(harness.ROOT / "BENCHMARK.json")["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", ["iot_alerts.calm", "iot_rescore.storm_archive"])
def test_traced_rehearsal_reads_span_metrics_and_no_device_number(name):
    res = _run(_cell(name, seconds=3.0, trace=True))
    assert res["correct"]
    got = set(res["metrics"])
    assert {"decode_ms.stream", "land_ms.stream"} <= got or {"decode_ms.batch", "parse_ms.batch"} <= got
    # a CPU run writes no number under a device metric's name
    assert not {m for m in got if "roofline" in m or "device_" in m}


@pytest.mark.parametrize("name", ["iot_alerts.calm", "iot_rescore.calm_archive"])
def test_the_bfloat16_control_is_not_correct(name):
    res = _run(_cell(name), control=True)
    assert not res["correct"]
    assert res["checks"]["score_abs_err"]["value"] > 10 * res["checks"]["score_abs_err"]["limit"]


def test_a_state_left_unchanged_is_not_correct(monkeypatch):
    from data_accelerator_tpu_torch.runtime import processor

    monkeypatch.setattr(processor, "update_buffers", lambda buf, *a, **k: buf)
    res = _run(_cell("iot_alerts.calm"))
    assert not res["correct"] and res["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["iot_alerts.alert_storm", "iot_rescore.calm_archive"])
def test_half_of_each_batch_left_out_is_not_correct(monkeypatch, name):
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    json_bytes, rows = FlowProcessor.encode_json_bytes, FlowProcessor.encode_rows

    def half_bytes(self, data, *a, **k):
        lines = data.split(b"\n")
        return json_bytes(self, b"\n".join(lines[: len(lines) // 2]) + b"\n", *a, **k)

    def half_rows(self, r, *a, **k):
        return rows(self, r[: len(r) // 2], *a, **k)

    monkeypatch.setattr(FlowProcessor, "encode_json_bytes", half_bytes)
    monkeypatch.setattr(FlowProcessor, "encode_rows", half_rows)
    res = _run(_cell(name))
    assert not res["correct"] and res["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["iot_alerts.calm", "iot_rescore.storm_archive"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch, name):
    from data_accelerator_tpu_torch.udf import samples

    plain = samples.anomaly_score_plain
    monkeypatch.setattr(samples, "anomaly_score_plain", lambda x, mu: plain(x, mu) * 0.999)
    res = _run(_cell(name))
    assert not res["correct"]


def test_the_command_needs_a_card(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "streambench/run.py", "--workload", "iot_alerts.calm",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{\"correct\"")]


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths``, the command exits non-zero and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "streambench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run(
        [sys.executable, "streambench/run.py", "--workload", "iot_rescore.calm_archive",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert "correct" not in p.stdout
