"""The traffic generator: deterministic by seed, its payload exactly
the columns the references regenerate, each mix's share of alerts, the
existing mixes' bytes pinned, and a side stream's readings on their
schedule."""

import hashlib
import json
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from pathlib import Path

from streambench.harness import HERE, load_json
from streambench.reference import iot
from streambench.traffic import generator

MIXES = ("alert_storm", "calm")
SEED = 2**31 + 7  # the driver's seeds are large


def _mix(name):
    return load_json(HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("mix", MIXES)
def test_events_are_deterministic_by_seed(mix):
    a = generator.events(_mix(mix), SEED, 5000)
    b = generator.events(_mix(mix), SEED, 5000)
    c = generator.events(_mix(mix), SEED + 1, 5000)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["temp_milli"], c["temp_milli"])


@pytest.mark.parametrize("mix", MIXES)
def test_lines_carry_exactly_the_columns(mix):
    cols = generator.events(_mix(mix), SEED, 4000)
    buf, off = generator.encode_lines(cols)
    lines = buf.split(b"\n")[:-1]
    assert len(lines) == 4000 and off[-1] == len(buf)
    for i, line in enumerate(lines):
        d = json.loads(line)
        dd = d["deviceDetails"]
        assert dd["deviceId"] == cols["device_id"][i]
        assert dd["deviceType"] == generator.DEVICE_TYPES[cols["type"][i]]
        assert dd["homeId"] == cols["home_id"][i]
        assert dd["status"] == cols["status"][i]
        assert round(dd["temperature"] * 1000) == cols["temp_milli"][i]
        assert d["eventTimeStamp"] == generator.BASE_MS + i
        assert buf[off[i]:off[i + 1]] == line + b"\n"


@pytest.mark.parametrize("mix,lo,hi", [("alert_storm", 0.825, 0.843), ("calm", 0.009, 0.011)])
def test_share_of_alerts(mix, lo, hi):
    cols = generator.events(_mix(mix), SEED, 400_000)
    s = iot.score(iot.temperature_f32(cols["temp_milli"]), cols["device_id"])
    assert lo < (s > iot.THRESHOLD).mean() < hi


def test_calm_events_stay_clear_of_the_threshold():
    """Every calm event is an alert by a margin or inside its band by
    one: no event of the calm mix lies near the threshold."""
    cols = generator.events(_mix("calm"), SEED, 400_000)
    s = iot.score(iot.temperature_f32(cols["temp_milli"]), cols["device_id"])
    assert np.abs(s - iot.THRESHOLD).min() > 0.01


def test_door_events_and_open_share():
    cols = generator.events(_mix("alert_storm"), SEED, 400_000)
    door = cols["type"] == generator.DOOR
    assert 0.018 < door.mean() < 0.022
    assert 0.45 < (cols["status"][door] == 0).mean() < 0.55
    assert (cols["status"][~door] == 1).all()


def test_pool_chunks_wrap_around():
    pool = generator.Pool(_mix("calm"), SEED, 1000)
    got = b"".join(bytes(c) for c in pool.chunks(990, 1012))
    want = pool.buf[pool.off[990]:] + pool.buf[:pool.off[12]]
    assert got == want


def test_archive_files_partition_by_hour(tmp_path):
    paths = generator.write_archive(_mix("calm"), SEED, tmp_path, 3, 100)
    assert [p.split("/")[-2] for p in paths] == ["00", "01", "02"]
    lines = b"".join(open(p, "rb").read() for p in paths).split(b"\n")[:-1]
    buf, _off = generator.encode_lines(generator.events(_mix("calm"), SEED, 300))
    assert b"\n".join(lines) + b"\n" == buf


# SHA-256 of the bytes each mix gave before side streams and lists of
# home ids were added: Pool(mix, SEED, 4096).buf, and a 2-file archive
# of 3,000 events a file (each file's path under the archive, then its
# bytes)
POOL_SHA = {
    "alert_storm": "31509eb999864348b4c660f9569a15082a9fc195bc2cba0bcc1fbd116820a1fe",
    "calm": "d4ecd9e073a4e715c169c331e956364aae42f5a5fb8b1c0dc7e42dc813da4a8f",
}
ARCHIVE_SHA = {
    "alert_storm": "4c803797b0f77c948fd0f0f7436916653be5e2d17849ab26fd9b27c5e8bc5f11",
    "calm": "08d5a9eba5c202ffbb23a5f8c22820f5aa03b985bc0e48a1abf3ab884106e48e",
}


@pytest.mark.parametrize("mix", MIXES)
def test_the_existing_mixes_give_the_same_bytes(mix, tmp_path):
    assert hashlib.sha256(generator.Pool(_mix(mix), SEED, 4096).buf).hexdigest() == POOL_SHA[mix]
    h = hashlib.sha256()
    for p in generator.write_archive(_mix(mix), SEED, tmp_path, 2, 3000):
        h.update(str(Path(p).relative_to(tmp_path)).encode())
        h.update(Path(p).read_bytes())
    assert h.hexdigest() == ARCHIVE_SHA[mix]


WEATHER = {"kind": "readings", "key_field": "stationId", "value_field": "windSpeed",
           "keys": [150, 32, 88], "period_s": 5, "offset_s": [0, 1, 2],
           "value": [[50.001, 120], [0, 50], [0, 50]]}


def test_a_list_of_homes_is_drawn_uniformly_and_leaves_the_rest():
    one = generator.events(_mix("calm"), SEED, 30_000)
    mix = dict(_mix("calm"), home_id=[150, 32, 88])
    many = generator.events(mix, SEED, 30_000)
    assert all(np.array_equal(one[k], many[k]) for k in one if k != "home_id")
    share = [(many["home_id"] == h).mean() for h in (150, 32, 88)]
    assert all(0.31 < s < 0.36 for s in share)
    buf, _off = generator.encode_lines(many)
    homes = [json.loads(line)["deviceDetails"]["homeId"] for line in buf.split(b"\n")[:50]]
    assert homes == many["home_id"][:50].tolist()


def test_readings_fall_due_on_their_schedule():
    cols = generator.readings(WEATHER, SEED, "weather", 9)
    assert cols["key"].tolist() == [150, 32, 88] * 3
    assert cols["due_s"].tolist() == [0, 1, 2, 5, 6, 7, 10, 11, 12]
    # a reading's value does not depend on how many are drawn
    more = generator.readings(WEATHER, SEED, "weather", 30)
    assert np.array_equal(more["value_milli"][:9], cols["value_milli"])
    v = more["value_milli"]
    st150 = more["key"] == 150
    assert (v[st150] >= 50001).all() and (v[st150] <= 120000).all()
    assert (v[~st150] >= 0).all() and (v[~st150] <= 50000).all()
    assert not np.array_equal(
        v, generator.readings(WEATHER, SEED + 1, "weather", 30)["value_milli"])
    # due_before counts exactly the readings due before a horizon
    for h in (0.0, 0.5, 5.0, 6.0, 6.5, 57.0):
        n = generator.due_before(WEATHER, h)
        due = generator.readings(WEATHER, SEED, "weather", n + 3)["due_s"]
        assert (due[:n] < h).all() and (due[n:] >= h).all()


def test_readings_lines_carry_the_columns():
    cols = generator.readings(WEATHER, SEED, "weather", 12)
    lines = generator.encode_readings(WEATHER, cols)
    for line, key, v in zip(lines, cols["key"], cols["value_milli"]):
        d = json.loads(line)
        assert line.endswith(b"\n") and list(d) == ["stationId", "windSpeed"]
        assert d["stationId"] == key and round(d["windSpeed"] * 1000) == v
        assert line.count(b".") == 1 and len(line.split(b".")[1]) == 5  # 3 decimals, "}\n"


def test_a_side_stream_of_another_kind_is_refused():
    with pytest.raises(ValueError):
        generator.side_stream({"streams": {"x": dict(WEATHER, kind="burst")}}, "x")


def test_the_side_stream_process_sends_each_reading_when_due(tmp_path):
    mix = dict(_mix("calm"), streams={"weather": dict(WEATHER, period_s=0.2,
                                                      offset_s=[0, 0.05, 0.1])})
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    srv = socket.create_server(("127.0.0.1", 0))
    gen = subprocess.Popen(
        [sys.executable, str(HERE / "traffic" / "generator.py"), "--mix", str(path),
         "--seed", str(SEED), "--mode", "socket", "--stream", "weather"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert gen.stdout.readline().split() == ["ready"]
        t0 = time.monotonic() + 0.2
        gen.stdin.write(f"go {srv.getsockname()[1]} {t0!r} 0 7\n")
        gen.stdin.flush()
        conn, _ = srv.accept()
        with conn:
            got = conn.makefile("rb").read()
        stats = json.loads(gen.stdout.readline())
        assert gen.wait(timeout=30) == 0
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait(timeout=30)
        srv.close()
    spec = generator.side_stream(mix, "weather")
    want = generator.encode_readings(spec, generator.readings(spec, SEED, "weather", 7))
    assert got == b"".join(want) and stats["generator_sent"] == 7
    # the last of the 7 is due 0.4 s after t0; the sends waited for it
    assert time.monotonic() >= t0 + 0.4 and stats["generator_late_max_ms"] >= 0.0
