"""The traffic generator: deterministic by seed, its payload exactly
the columns the references regenerate, and each mix's share of
alerts."""

import json

import numpy as np
import pytest

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
