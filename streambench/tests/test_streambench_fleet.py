"""The readers of the fleet rollup's per-layer metrics, on records made
by hand: ``group_gpu_ms.stream`` and ``group_roofline.stream`` read the
program's ``window-group`` spans on the card only, and nothing where
the program records no such span (a parent without it);
``group_window_share.stream`` reads the program's ``Group_*`` counters
from its metric store by batch time, and nothing where there are none.
The roofline counts the bytes of ``roofline/fleet_rollup.py``."""

import pytest

from streambench import harness

SPAN = "window-group"
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def _read(name, record):
    return harness.load_module("metrics", name).read(record)


def _record(spans, platform="gpu", profile=True):
    batches = [{"bt": 1000 * (i + 1), "spans": dict(s)} for i, s in enumerate(spans)]
    return {
        "config": "fleet_rollup",
        "device": {"platform": platform},
        "profile": {"batches": []} if profile else None,
        "peaks": PEAKS,
        "window_batches": batches,
        "ref_counts": {b["bt"]: {"rows": 200_000, "window_rows": 12_000_000,
                                 "groups": 877_000, "HotDevices": 14_000} for b in batches},
    }


def test_group_gpu_ms_is_the_spans_a_batch_on_the_card_only():
    rec = _record([{SPAN: 40.0, "poll": 1.0}, {SPAN: 50.0, "poll": 1.0}])
    assert _read("group_gpu_ms.stream", rec) == pytest.approx(45.0)
    assert _read("group_gpu_ms.stream", _record([{SPAN: 40.0}], platform="cpu")) is None
    assert _read("group_gpu_ms.stream", _record([{SPAN: 40.0}], profile=False)) is None
    assert _read("group_gpu_ms.stream", _record([{"poll": 1.0}])) is None


def test_group_roofline_is_the_group_bytes_over_the_spans_card_time():
    rec = _record([{SPAN: 40.0}, {SPAN: 60.0}])
    group_bytes = 8 * 12_000_000 + 16 * 877_000
    want = 100.0 * (2 * group_bytes) / PEAKS["hbm_bytes_per_s"] / 0.1
    assert _read("group_roofline.stream", rec) == pytest.approx(want)
    assert _read("group_roofline.stream", _record([{SPAN: 40.0}], platform="cpu")) is None
    assert _read("group_roofline.stream", _record([{"poll": 1.0}])) is None
    other = dict(rec, config="iot_alerts")
    assert _read("group_roofline.stream", other) is None


def test_step_bytes_count_the_batch_the_window_the_groups_and_the_rows():
    rl = harness.load_module("roofline", "fleet_rollup")
    c = {"rows": 10, "window_rows": 100, "groups": 7, "HotDevices": 3}
    assert rl.group_bytes(c) == 8 * 100 + 16 * 7
    assert rl.step_bytes(c) == 20 * 10 + 8 * 100 + 16 * 7 + 16 * 3


def test_group_window_share_reads_the_counters_by_batch_time():
    from data_accelerator_tpu_torch.obs.store import METRIC_STORE

    METRIC_STORE.clear()
    rec = _record([{SPAN: 1.0}, {SPAN: 1.0}], platform="cpu")
    assert _read("group_window_share.stream", rec) is None
    for bt, rows in ((1000, 600), (2000, 900), (9000, 5)):
        METRIC_STORE.add_point("DATAX-Fleet:Group_RowsScanned", bt, 1000.0)
        METRIC_STORE.add_point("DATAX-Fleet:Group_RowsInWindow", bt, float(rows))
    # the window's two batches, not the third
    assert _read("group_window_share.stream", rec) == pytest.approx(1500 / 2000)
    METRIC_STORE.clear()
