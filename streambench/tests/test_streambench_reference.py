"""The plain references against small hand-worked cases: the window's
edge, the score threshold and its gray band, the DoorLock filter, and
the comparison's counts of wrong rows."""

import math
from collections import Counter

import numpy as np
import pytest

from streambench.reference import iot


def _events(device_id, temp_milli, kind=None, status=None):
    n = len(device_id)
    ev = iot.Events.__new__(iot.Events)
    ev.n = n
    ev.device_id = np.asarray(device_id, np.int64)
    kind = np.asarray(kind if kind is not None else [0] * n)
    status = np.asarray(status if status is not None else [1] * n)
    ev.open_door = (kind == iot.DOOR) & (status == 0)
    t32 = iot.temperature_f32(np.asarray(temp_milli, np.int64))
    ev.temp = t32.astype(np.float64)
    ev.score = iot.score(t32, ev.device_id)
    ev.precision = "float64"
    return ev


def test_temperature_parses_as_the_json_text():
    t = iot.temperature_f32(np.array([0, 1, 27775, 100000]))
    assert t.dtype == np.float32
    assert list(t) == [np.float32(0.0), np.float32(0.001), np.float32(27.775), np.float32(100.0)]


def test_score_formula_and_threshold():
    # |x - mu| / (1 + |mu|) = ln 9 is the score 0.9 exactly
    mu = 3
    edge = mu + math.log(9.0) * (1 + mu)
    s = iot.score(np.array([edge - 0.01, edge + 0.01], np.float32), np.array([mu, mu]))
    assert s[0] < iot.THRESHOLD < s[1]
    assert iot.score(np.array([3.0], np.float32), np.array([3]))[0] == 0.5


def test_alerts_required_and_gray():
    # device 8 at 27.775 degrees scores within 2.2e-7 of 0.9: either side
    # is a faithful float32 answer; 60.0 is an alert, 10.0 is not
    ev = _events([8, 8, 8], [27775, 60000, 10000])
    e = iot.expected_batch(ev, np.arange(3))
    allowed, required = e["alerts"][8]
    assert allowed.size == 2 and required == 1
    t = iot.Tally()
    t.alerts([{"deviceId": 8, "score": float(allowed[0])}], e["alerts"])
    assert t.rows_wrong == 0
    t.alerts([{"deviceId": 8, "score": float(s)} for s in allowed], e["alerts"])
    assert t.rows_wrong == 0
    t.alerts([], e["alerts"])
    assert t.rows_wrong == 1
    t.alerts([{"deviceId": 8, "score": 0.95}] * 3, e["alerts"])
    assert t.rows_wrong == 2


def test_score_error_is_the_sorted_pairing():
    ev = _events([2, 2], [12000, 9000])
    e = iot.expected_batch(ev, np.arange(2))
    allowed, _r = e["alerts"][2]
    t = iot.Tally()
    rows = [{"deviceId": 2, "score": float(allowed[1]) + 3e-6},
            {"deviceId": 2, "score": float(allowed[0])}]
    t.alerts(rows, e["alerts"])
    assert t.rows_wrong == 0 and t.score_abs_err == pytest.approx(3e-6, rel=1e-3)


def test_door_filter_needs_doorlock_and_status_0():
    ev = _events([1, 2, 3, 4], [1000] * 4, kind=[2, 2, 0, 1], status=[0, 1, 0, 0])
    e = iot.expected_batch(ev, np.arange(4))
    assert e["open_doors"] == Counter({1: 1})
    t = iot.Tally()
    t.open_doors([{"deviceId": 1, "eventTimeStamp": 5000}], e["open_doors"], 5000)
    assert t.rows_wrong == 0
    t.open_doors([{"deviceId": 1, "eventTimeStamp": 4000}], e["open_doors"], 5000)
    assert t.rows_wrong == 2  # a row at another time, and the one missing


def _batch(cnt, total):
    return {"cnt": np.array(cnt, np.int64), "sum": np.array(total, np.float64)}


def test_window_edge_and_ring():
    z = [0] * 9
    one = _batch([0, 1] + z[2:], [0, 10.0] + z[2:])
    # batch times 0..6 s apart by 1000 ms: at t = 6000 the window
    # [1000, 6000] holds batches 1..6; batch 0 lies 6000 ms back
    bts = [0, 1000, 2000, 3000, 4000, 5000, 6000]
    w = iot.window_means([one] * 7, bts, 5000, 6, "float64")
    assert w[5] == {1: (6, 10.0)}  # 5000 ms back is inside
    assert w[6] == {1: (6, 10.0)}
    late = [0, 5001]
    assert iot.window_means([one] * 2, late, 5000, 6, "float64")[1] == {1: (1, 10.0)}
    # the ring holds 6 slots: a 7th batch 100 ms apart pushes the first out
    dense = [0, 100, 200, 300, 400, 500, 600]
    assert iot.window_means([one] * 7, dense, 5000, 6, "float64")[6] == {1: (6, 10.0)}


def test_heat_rows_count_wrong_counts_and_value_error():
    want = {1: (4, 20.0), 2: (2, 5.0)}
    t = iot.Tally()
    t.heat([{"deviceId": 1, "Cnt": 4, "AvgT": 20.0 * (1 + 2e-6)},
            {"deviceId": 2, "Cnt": 2, "AvgT": 5.0}], want)
    assert t.rows_wrong == 0 and t.avgt_rel_err == pytest.approx(2e-6)
    t.heat([{"deviceId": 1, "Cnt": 3, "AvgT": 20.0}], want)
    assert t.rows_wrong == 2  # a wrong count, and device 2 missing


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.005859375, 100.3], np.float32)
    got = iot.bf16(x)
    assert list(got[:3]) == [1.0, 1.0, 1.0078125]
    assert abs(got[3] - 100.5) < 1e-6


def test_stray_rows_count_rows_of_unknown_batches():
    out = {"OpenDoors": {1000: [{}], 2000: [{}, {}]}}
    assert iot.stray_rows(out, {1000}) == 2
