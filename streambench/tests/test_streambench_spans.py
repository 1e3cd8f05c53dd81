"""The span metrics that read the program's own spans for the source,
the loop's tail, the blob sink's two halves and the card-timed device
step: a traced CPU rehearsal of one streaming cell and one batch cell
reports a number for each, and none for ``step_gpu_ms.stream``, a
device number; on a record without the spans, as from a program that
lacks them, every reader returns None."""

import shutil

import pytest

from streambench import harness

SEED = 2**31 + 11
STREAM = ["poll_ms.stream", "source_wait_ms.stream", "tail_ms.stream",
          "blob_encode_ms.stream", "blob_write_ms.stream"]
BATCH = ["read_ms.batch", "blob_encode_ms.batch", "blob_write_ms.batch"]


@pytest.fixture(autouse=True)
def _caches(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    harness.set_cache_env()


def _rehearse(name):
    from data_accelerator_tpu_torch.obs.store import METRIC_STORE

    METRIC_STORE.clear()
    cell = harness.find_cell(name, SEED, 3.0, True)
    loop = harness.load_module("loops", cell.workload["loop"])
    loop.shrink(cell)
    traffic = loop.start_traffic(cell)
    try:
        return harness.run_cell(cell, "cpu", traffic)[0]
    finally:
        loop.stop_traffic(traffic)
        shutil.rmtree(cell.tmp, ignore_errors=True)


@pytest.mark.parametrize("name, metrics", [
    ("iot_alerts.alert_storm", STREAM), ("iot_rescore.storm_archive", BATCH)])
def test_a_traced_rehearsal_reads_the_span_metrics(name, metrics):
    res = _rehearse(name)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for m in metrics:
        assert m in got and got[m]["unit"] == "ms" and got[m]["value"] >= 0.0, m
    assert got[metrics[0]]["value"] > 0.0
    assert "step_gpu_ms.stream" not in got


def test_the_readers_find_nothing_without_the_spans():
    old = {"device": {"platform": "gpu"}, "profile": {"batches": []},
           "window_batches": [{"spans": {"decode": 5.0, "device-step": 1.0}}],
           "window_passes": [{"spans": {"decode": 5.0}, "chunks": [{"rows": 1}]}]}
    for m in STREAM + BATCH + ["step_gpu_ms.stream"]:
        assert harness.load_module("metrics", m).read(old) is None, m
    new = dict(old, window_batches=[{"spans": {"poll": 1.0, "device-step": 7.0}}])
    assert harness.load_module("metrics", "step_gpu_ms.stream").read(new) == 7.0
    cpu = dict(new, device={"platform": "cpu"})
    assert harness.load_module("metrics", "step_gpu_ms.stream").read(cpu) is None
