"""The one traffic generator of the benchmark.

A traffic mix is a JSON file of parameters beside this file
(``traffic/<mix>.json``); this module turns a mix and a seed into IoT
telemetry events, the distribution of ``bench.py::make_json_payload``:
device ids uniform on a range, a share of DoorLock events of which half
report an open door (``status`` 0), the rest Heating or WindSpeed, a
home id (one, or drawn uniformly from a list), and temperatures at three
decimals drawn by the mix's law.

A mix may also name side streams (``"streams": {<name>: {...}}``), each
sent to the configuration's source of the same name on a socket of its
own. The one kind is ``readings``: every key of ``keys`` reports every
``period_s``, reading ``k`` of key ``j`` due at ``t0 + offset_s[j] +
k * period_s``, its value drawn from the seed uniformly on
``value[j]`` at three decimals, sent as ``{"<key_field>":<key>,
"<value_field>":<value>}``.

It imports neither torch nor the program under test. The benchmark runs
it as a separate process a stream, in one of three modes:

- ``socket``: build a pool of events from the seed, print ``ready``,
  wait for ``go <port> <t0> <rate> <total>`` on stdin, then send event
  ``i`` of the stream (pool event ``i mod pool``) when it is due, at
  ``t0 + i / rate`` on ``time.monotonic()``, whatever the receiver does:
  an open loop. At the end it prints its lateness as one JSON line.
- ``socket`` with ``--stream <name>``: the side stream ``name``; after
  the same ``go`` line (its rate unused) it sends readings ``[0,
  total)``, each when it is due, whatever the receiver does.
- ``files``: write an archive of ``files`` JSON-lines files of
  ``events_per_file`` events each into ``<out>/<yyyy/MM/dd/HH>/``, one
  hour partition a file, then print ``done``.

The plain references regenerate the same columns with ``events()`` and
``readings()``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import time
import zlib
from pathlib import Path

import numpy as np

DEVICE_TYPES = ("Heating", "WindSpeed", "DoorLock")
DOOR = 2
# the payload's own event timestamp: BASE_MS + the event's pool index
BASE_MS = 1_700_000_000_000
# one hour partition a file, from this hour on
ARCHIVE_EPOCH_S = 1_767_225_600  # 2026-01-01T00:00:00Z
# the open loop sends whatever is due every TICK_S
TICK_S = 0.002


def load_mix(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def rng_for(seed: int, stream: str = "") -> np.random.Generator:
    """The main stream's generator, or a side stream's, by its name."""
    entropy = abs(int(seed))
    if stream:
        entropy = [entropy, zlib.crc32(stream.encode())]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def temperatures_milli(rng, device_id: np.ndarray, law: dict) -> np.ndarray:
    """Temperatures in thousandths of a degree (the payload prints three
    decimals, so these integers are exactly what is sent).

    ``uniform``: on [lo, hi]. ``band``: the anomaly rule's band about
    each device's mean ``mu`` = device id, of half-width
    ``scale * (1 + mu)`` (the score crosses its threshold there): a
    share ``alert_share`` drawn on [mu + outer * half, hi], the rest on
    [lo, mu + inner * half]."""
    n = device_id.size
    if law["law"] == "uniform":
        lo, hi = law["lo"], law["hi"]
        return rng.integers(int(lo * 1000), int(hi * 1000) + 1, n)
    if law["law"] == "band":
        mu = device_id.astype(np.float64)
        half = law["scale"] * (1.0 + mu)
        alert = rng.random(n) < law["alert_share"]
        u = rng.random(n)
        calm_hi = mu + law["inner"] * half
        alert_lo = mu + law["outer"] * half
        t = np.where(
            alert,
            alert_lo + u * (law["hi"] - alert_lo),
            law["lo"] + u * (calm_hi - law["lo"]),
        )
        return np.floor(t * 1000.0).astype(np.int64)
    raise ValueError(f"unknown temperature law {law['law']!r}")


def events(mix: dict, seed: int, n: int) -> dict:
    """The first ``n`` events of the mix under ``seed``, as columns:
    ``device_id``, ``type`` (index into ``DEVICE_TYPES``), ``home_id``,
    ``status``, ``temp_milli``. A list of home ids is drawn from last,
    so the other columns are those of one home id."""
    rng = rng_for(seed)
    lo, hi = mix["device_id"]
    device_id = rng.integers(lo, hi + 1, n)
    is_door = rng.random(n) < mix["door_share"]
    other = rng.integers(0, 2, n)
    dtype = np.where(is_door, DOOR, other)
    status = np.where(is_door & (rng.random(n) < mix["door_open_share"]), 0, 1)
    temp_milli = temperatures_milli(rng, device_id, mix["temperature"])
    homes = mix["home_id"]
    if isinstance(homes, list):
        home_id = np.asarray(homes, np.int64)[rng.integers(0, len(homes), n)]
    else:
        home_id = np.full(n, homes, np.int64)
    return {
        "device_id": device_id.astype(np.int64),
        "type": dtype.astype(np.int64),
        "home_id": home_id,
        "status": status.astype(np.int64),
        "temp_milli": temp_milli,
    }


def side_stream(mix: dict, name: str) -> dict:
    """The mix's side stream ``name``, checked to be of a kind this
    generator makes."""
    spec = mix["streams"][name]
    if spec.get("kind") != "readings":
        raise ValueError(f"side stream {name!r}: unknown kind {spec.get('kind')!r}")
    if any(lo < 0 or hi < lo for lo, hi in spec["value"]):
        raise ValueError(f"side stream {name!r}: a value range is not 0 <= lo <= hi")
    return spec


def due_before(spec: dict, horizon_s: float) -> int:
    """How many readings fall due before ``t0 + horizon_s``."""
    p = spec["period_s"]
    return sum(max(0, math.ceil((horizon_s - off) / p)) for off in spec["offset_s"])


def readings(spec: dict, seed: int, name: str, n: int) -> dict:
    """The side stream's first ``n`` readings in the order they fall
    due, as columns: ``key`` (the key itself), ``value_milli`` (the
    value in thousandths) and ``due_s`` (after ``t0``). A reading's
    value does not depend on ``n``."""
    keys = np.asarray(spec["keys"], np.int64)
    off = np.asarray(spec["offset_s"], np.float64)
    k = np.arange(n, dtype=np.float64)
    due = (off[:, None] + k[None, :] * spec["period_s"]).ravel()
    j = np.repeat(np.arange(keys.size), n)
    order = np.lexsort((j, due))[:n]
    due, j = due[order], j[order]
    lo, hi = np.round(np.asarray(spec["value"], np.float64) * 1000).astype(np.int64).T
    u = rng_for(seed, name).random(n)
    milli = lo[j] + np.floor(u * (hi[j] - lo[j] + 1)).astype(np.int64)
    return {"key": keys[j], "value_milli": milli, "due_s": due}


def encode_readings(spec: dict, cols: dict) -> list:
    """The readings as newline-terminated compact JSON lines."""
    head = b'{"%s":%%d,"%s":%%d.%%03d}\n' % (spec["key_field"].encode(),
                                           spec["value_field"].encode())
    return [head % (key, v // 1000, v % 1000)
            for key, v in zip(cols["key"].tolist(), cols["value_milli"].tolist())]


def _digits(v: np.ndarray) -> np.ndarray:
    """Decimal digit count of each non-negative integer."""
    w = np.ones(v.shape, np.int64)
    x = v // 10
    while x.any():
        w += x > 0
        x //= 10
    return w


# the four decimal digits of 0..9999, zero-padded
_QUADS = np.frombuffer(
    "".join(f"{i:04d}" for i in range(10000)).encode(), np.uint8
).reshape(10000, 4)


def _put_int(m: np.ndarray, col: int, v: np.ndarray, width: int) -> None:
    """Write ``v`` (each of exactly ``width`` digits) at column ``col``,
    four digits a lookup, from the right."""
    end = col + width
    while end > col:
        k = min(4, end - col)
        v, quad = np.divmod(v, 10000)
        m[:, end - k:end] = _QUADS[quad, 4 - k:]
        end -= k


def encode_lines(cols: dict):
    """The events as newline-terminated compact JSON lines, in the
    payload's layout. Returns (one bytes buffer, offsets[n + 1]).

    Vectorised: rows that share a layout (the widths of their numbers
    and their device type) are written as one byte matrix, column by
    column; the lines then join in event order."""
    n = cols["device_id"].size
    ts = BASE_MS + np.arange(n, dtype=np.int64)
    tint = cols["temp_milli"] // 1000
    tfrac = cols["temp_milli"] % 1000
    ints = {
        "device_id": cols["device_id"], "home_id": cols["home_id"],
        "status": cols["status"], "tint": tint, "ts": ts,
    }
    widths = {k: _digits(v) for k, v in ints.items()}
    parts = [
        b'{"deviceDetails":{"deviceId":', "device_id",
        b',"deviceType":"', "type", b'","homeId":', "home_id",
        b',"status":', "status", b',"temperature":', "tint", b".", "tfrac",
        b'},"eventTimeStamp":', "ts", b"}\n",
    ]
    names = [t.encode() for t in DEVICE_TYPES]
    key = cols["type"].copy()
    for k in ints:
        key = key * 32 + widths[k]
    lines = np.empty(n, dtype=object)
    lengths = np.empty(n, np.int64)
    for layout in np.unique(key):
        rows = np.nonzero(key == layout)[0]
        r0 = rows[0]
        w = {k: int(widths[k][r0]) for k in ints}
        type_name = names[int(cols["type"][r0])]
        pieces, fields, col = [], [], 0
        for p in parts:
            if isinstance(p, bytes) or p == "type":
                text = type_name if p == "type" else p
                pieces.append(text)
                col += len(text)
            else:
                width = 3 if p == "tfrac" else w[p]
                pieces.append(b"0" * width)
                fields.append((col, p, width))
                col += width
        size = col
        template = np.frombuffer(b"".join(pieces), np.uint8)
        m = np.repeat(template[None, :], rows.size, axis=0)
        for col, p, width in fields:
            v = tfrac[rows] if p == "tfrac" else ints[p][rows]
            _put_int(m, col, v, width)
        lines[rows] = m.view(f"S{size}").ravel().tolist()
        lengths[rows] = size
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return b"".join(lines.tolist()), offsets


def write_archive(mix: dict, seed: int, out: Path, files: int,
                  events_per_file: int) -> list:
    """``files`` JSON-lines files of consecutive events, file ``k`` in
    the hour partition ``k`` hours after ``ARCHIVE_EPOCH_S``."""
    cols = events(mix, seed, files * events_per_file)
    buf, off = encode_lines(cols)
    paths = []
    for k in range(files):
        t = time.gmtime(ARCHIVE_EPOCH_S + 3600 * k)
        d = out / f"{t.tm_year:04d}/{t.tm_mon:02d}/{t.tm_mday:02d}/{t.tm_hour:02d}"
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"part-{k:05d}.json"
        a, b = off[k * events_per_file], off[(k + 1) * events_per_file]
        p.write_bytes(buf[a:b])
        paths.append(str(p))
    return paths


class Pool:
    """The stream: event ``i`` is pool event ``i mod size``."""

    def __init__(self, mix: dict, seed: int, size: int):
        self.size = size
        self.buf, self.off = encode_lines(events(mix, seed, size))
        self.view = memoryview(self.buf)

    def chunks(self, a: int, b: int):
        """Byte slices of stream events [a, b)."""
        while a < b:
            i = a % self.size
            j = min(self.size, i + (b - a))
            yield self.view[self.off[i]:self.off[j]]
            a += j - i


def send_open_loop(pool: Pool, port: int, t0: float, rate: float,
                   total: int) -> dict:
    """Send stream events [0, total) on their schedule; returns how late
    the sends ran, in ms past the due time of each tick's first event."""
    late = []
    sent = 0
    with socket.create_connection(("127.0.0.1", port), timeout=600) as conn:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while sent < total:
            now = time.monotonic()
            due = min(total, int((now - t0) * rate) + 1) if now >= t0 else 0
            if due > sent:
                late.append((now - (t0 + sent / rate)) * 1000.0)
                for c in pool.chunks(sent, due):
                    conn.sendall(c)
                sent = due
            nxt = t0 + sent / rate
            time.sleep(max(0.0, min(TICK_S, nxt - time.monotonic())))
    late = np.asarray(late) if late else np.zeros(1)
    return {
        "generator_sent": sent,
        "generator_late_p50_ms": float(np.percentile(late, 50)),
        "generator_late_p99_ms": float(np.percentile(late, 99)),
        "generator_late_max_ms": float(late.max()),
    }


def send_on_schedule(lines: list, due_s: np.ndarray, port: int, t0: float) -> dict:
    """Send each line at ``t0 + due_s[i]``; returns how late the sends
    ran, in ms past each line's due time."""
    late = []
    with socket.create_connection(("127.0.0.1", port), timeout=600) as conn:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for line, due in zip(lines, due_s.tolist()):
            time.sleep(max(0.0, t0 + due - time.monotonic()))
            late.append((time.monotonic() - (t0 + due)) * 1000.0)
            conn.sendall(line)
    late = np.asarray(late) if late else np.zeros(1)
    return {"generator_sent": len(lines),
            "generator_late_max_ms": float(late.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--mode", choices=("socket", "files"), required=True)
    ap.add_argument("--stream", default="")
    ap.add_argument("--pool", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--files", type=int, default=0)
    ap.add_argument("--events-per-file", type=int, default=0)
    a = ap.parse_args(argv)
    mix = load_mix(a.mix)
    if a.mode == "files":
        write_archive(mix, a.seed, Path(a.out), a.files, a.events_per_file)
        print("done", flush=True)
        return 0
    if a.stream:
        spec = side_stream(mix, a.stream)
        print("ready", flush=True)
        line = sys.stdin.readline().split()
        if not line or line[0] != "go":
            return 0
        port, t0, total = int(line[1]), float(line[2]), int(line[4])
        cols = readings(spec, a.seed, a.stream, total)
        stats = send_on_schedule(encode_readings(spec, cols), cols["due_s"], port, t0)
        print(json.dumps(stats), flush=True)
        return 0
    pool = Pool(mix, a.seed, a.pool)
    print(f"ready {pool.size} {len(pool.buf)}", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 0
    port, t0, rate, total = int(line[1]), float(line[2]), float(line[3]), int(line[4])
    stats = send_open_loop(pool, port, t0, rate, total)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
