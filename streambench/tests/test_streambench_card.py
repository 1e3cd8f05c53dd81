"""On the card (skips without one): each cell's program run comes out
correct and its bfloat16 control does not, at a short window. Run them
with ``python -m pytest streambench/tests -m cuda``."""

import shutil

import pytest

from streambench import harness

# every cell of BENCHMARK.json, found there
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def _run(name, control, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    harness.set_cache_env()
    from data_accelerator_tpu_torch.obs.store import METRIC_STORE

    METRIC_STORE.clear()
    cell = harness.find_cell(name, 2**31 + 41, 4.0, False)
    loop = harness.load_module("loops", cell.workload["loop"])
    traffic = loop.start_traffic(cell)
    try:
        return harness.run_cell(cell, "cuda", traffic, control=control)[0]
    finally:
        loop.stop_traffic(traffic)
        shutil.rmtree(cell.tmp, ignore_errors=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_correct_and_control_not_on_the_card(name, card, tmp_path, monkeypatch):
    res = _run(name, False, tmp_path, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == card
    ctl = _run(name, True, tmp_path, monkeypatch)
    assert not ctl["correct"], ctl["checks"]
