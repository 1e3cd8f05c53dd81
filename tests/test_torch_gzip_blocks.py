"""The blob sink's gzip (``utils/fs.py::gzip_bytes``): level-9 deflate
in parallel blocks of at least 64 KiB, each primed with the previous
block's last 32 KiB, written as one RFC 1952 member.

- Round trip: every length around the block edges, 5 MB of JSON lines,
  random bytes and non-ASCII text inflate to what went in.
- Form: one member (nothing after it), the header and trailer bytes.
- Same work: within 0.5% of ``gzip.compress(d, 9)`` on payloads shaped
  like the storm's and the fleet's alert rows.
- Threads: writers sharing one ``FileSink`` each get their own file,
  whole; a set ``abort`` discards the temp file; a pool worker deflates
  inline; a forked child builds its own pool.
- The ``sink/file/write`` span's ``blocks`` and ``gz_bytes``, and the
  same rows as the JAX package's ``FileSink`` writes.
"""

import gzip
import json
import os
import random
import struct
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from data_accelerator_tpu.runtime.sinks import FileSink as JaxFileSink
from data_accelerator_tpu_torch.compile.planner import TableData, ViewSchema
from data_accelerator_tpu_torch.core.schema import StringDictionary
from data_accelerator_tpu_torch.obs.tracing import Tracer
from data_accelerator_tpu_torch.runtime.materialize import LandedTable, materialize_rows
from data_accelerator_tpu_torch.runtime.sinks import FileSink
from data_accelerator_tpu_torch.utils import fs

KIB = 1024
BLOCK = 64 * KIB
BATCH_MS = 1_767_225_600_000


class _Spans(Tracer):
    """A tracer that keeps each span's name and props."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def _emit_span(self, ctx, name, span_id, parent_id, start_ts, duration_ms, props):
        self.spans.append((name, dict(props)))


def _jsonl(n, seed=0, fleet=False):
    """``n`` alert rows as the blob sink renders them: the storm's
    ``{deviceId, score}`` or the fleet's ``{deviceId, Cnt, AvgT, MaxT}``."""
    rs = random.Random(seed)
    if fleet:
        rows = ({"deviceId": rs.randint(1, 1_000_000), "Cnt": rs.randint(1, 12),
                 "AvgT": rs.uniform(95, 100), "MaxT": rs.uniform(95, 100)}
                for _ in range(n))
    else:
        rows = ({"deviceId": rs.randint(1, 8), "score": rs.random()} for _ in range(n))
    return "".join(json.dumps(r) + "\n" for r in rows).encode()


def _payload(case):
    if isinstance(case, int):
        # text-like bytes, so the blocks' shared window matters
        return (_jsonl(case // 20 + 1)[:case]).ljust(case, b"x")
    if case == "jsonl_5mb":
        return _jsonl(110_000)
    if case == "random":
        return random.Random(7).randbytes(3 * BLOCK + 123)
    assert case == "utf8"
    text = "".join(f'{{"name": "café üß \U0001d11e {i}", "v": "日本語"}}\n' for i in range(9_000))
    return text.encode("utf-8")


ROUND_TRIP = [0, 1, BLOCK - 1, BLOCK, BLOCK + 1, 2 * BLOCK - 1, 2 * BLOCK,
              2 * BLOCK + 1, 8 * BLOCK, "jsonl_5mb", "random", "utf8"]


@pytest.mark.parametrize("case", ROUND_TRIP, ids=str)
def test_round_trip(case):
    d = _payload(case)
    assert gzip.decompress(fs.gzip_bytes(d)) == d


@pytest.mark.parametrize("case", [0, BLOCK, 2 * BLOCK, 8 * BLOCK + 5, "utf8", "random"], ids=str)
def test_one_member(case):
    d = _payload(case)
    inflate = zlib.decompressobj(31)
    assert inflate.decompress(fs.gzip_bytes(d)) + inflate.flush() == d
    assert inflate.eof and inflate.unused_data == b""


@pytest.mark.parametrize("case", [1, BLOCK + 1, 8 * BLOCK, "random"], ids=str)
def test_header_and_trailer(case):
    d = _payload(case)
    before = int(time.time())
    out = fs.gzip_bytes(d)
    after = int(time.time())
    magic, method, flags, mtime, xfl, os_byte = struct.unpack("<2sBBIBB", out[:10])
    assert (magic, method, flags, xfl, os_byte) == (b"\x1f\x8b", 8, 0, 2, 255)
    assert before <= mtime <= after
    crc, size = struct.unpack("<2I", out[-8:])
    assert crc == zlib.crc32(d) and size == len(d) & 0xFFFFFFFF
    # the body is raw deflate, one stream, ending where the trailer starts
    raw = zlib.decompressobj(-15)
    assert raw.decompress(out[10:-8]) == d and raw.eof and raw.unused_data == b""


@pytest.mark.parametrize("fleet,n", [(False, 16_000), (True, 11_000)], ids=["storm", "fleet"])
def test_level_9_size_is_kept(fleet, n):
    d = _jsonl(n, seed=3, fleet=fleet)
    assert 0.65e6 <= len(d) <= 1.1e6
    ours, k = fs._gzip(d)
    assert k == min(fs.gzip_workers(), len(d) // BLOCK)
    ref = len(gzip.compress(d, 9))
    assert abs(len(ours) - ref) <= 0.005 * ref


@pytest.mark.parametrize("threads", [8, 16])
def test_threads_sharing_a_sink_each_write_their_own_whole_file(tmp_path, threads):
    sink = FileSink(str(tmp_path), "gzip")
    texts = [_jsonl(3_000 + 900 * i, seed=i).decode() for i in range(threads)]
    start = threading.Barrier(threads)
    errors = []

    def write(i):
        try:
            start.wait(timeout=30)
            sink._write("Alerts", 1, BATCH_MS, False, lambda: texts[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=write, args=(i,)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers) and not errors
    files = sorted(p for p in tmp_path.rglob("*") if p.is_file())
    assert all(p.name.endswith(".json.gz") for p in files)  # no temp left
    got = sorted(gzip.decompress(p.read_bytes()).decode() for p in files)
    assert got == sorted(texts)


@pytest.mark.parametrize("size", [1_000, 4 * BLOCK])
def test_set_abort_discards_the_temp_file(tmp_path, size):
    path = tmp_path / "out" / "Alerts.json.gz"
    abort = threading.Event()
    abort.set()
    with pytest.raises(InterruptedError):
        fs.write_text(str(path), _payload(size).decode(), abort=abort)
    assert list(path.parent.iterdir()) == []


@pytest.mark.parametrize("size", [4 * BLOCK, 16 * BLOCK])
def test_the_pools_own_threads_deflate_inline(size):
    d = _payload(size)
    pool = fs._gzip_pool()
    # as many calls as the pool has threads: one that submitted to the
    # pool would wait on work no free thread could take
    futures = [pool.submit(fs._gzip, d) for _ in range(fs.gzip_workers())]
    for f in futures:
        out, k = f.result(timeout=60)
        assert k == 1 and gzip.decompress(out) == d


@pytest.mark.parametrize("size", [2 * BLOCK, 8 * BLOCK])
def test_a_new_process_builds_its_own_pool(monkeypatch, size):
    first = fs._gzip_pool()
    pid = os.getpid()
    monkeypatch.setattr(fs.os, "getpid", lambda: pid + 1)
    try:
        child = fs._gzip_pool()
        assert child is not first and fs._gzip_pool() is child
        d = _payload(size)
        assert gzip.decompress(fs.gzip_bytes(d)) == d
    finally:
        monkeypatch.undo()
        assert fs._gzip_pool() is not child  # rebuilt for this process
        child.shutdown(wait=True)


def _landed(n, seed):
    """A flat landed table of ``n`` storm-like alert rows and its rows."""
    rs = np.random.default_rng(seed)
    cols = {"deviceId": rs.integers(1, 1_000_000, n).astype(np.int32),
            "score": rs.random(n).astype(np.float32)}
    table = TableData(cols, np.ones(n, bool))
    schema = ViewSchema({"deviceId": "long", "score": "double"})
    d = StringDictionary()
    return (LandedTable.compact(table, schema, d, BATCH_MS),
            materialize_rows(table, schema, d, BATCH_MS))


def _files(folder):
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(Path(folder).rglob("*.gz"))}


@pytest.mark.parametrize("n", [2_000, 20_000])
def test_write_span_counts_blocks_and_gzip_bytes(tmp_path, n):
    landed, _ = _landed(n, n)
    tracer = _Spans()
    trace = tracer.begin("test/batch")
    with trace.activate():
        assert FileSink(str(tmp_path), "gzip").write_landed("Alerts", landed, BATCH_MS) == (n, n)
    trace.end()
    (props,) = [p for name, p in tracer.spans if name == "sink/file/write"]
    (path,) = sorted(tmp_path.rglob("*.gz"))
    assert props["gz_bytes"] == path.stat().st_size
    expected = max(1, min(fs.gzip_workers(), props["bytes"] // BLOCK))
    assert props["blocks"] == expected
    if n == 2_000:
        assert props["blocks"] == 1
    else:
        assert props["blocks"] > 1 or fs.gzip_workers() == 1


@pytest.mark.parametrize("n", [2_000, 20_000])
def test_landed_gzip_file_inflates_to_the_jax_packages_rows(tmp_path, n):
    landed, rows = _landed(n, 100 + n)
    FileSink(str(tmp_path / "torch"), "gzip").write_landed("Alerts", landed, BATCH_MS)
    JaxFileSink(str(tmp_path / "jax"), "gzip").write("Alerts", rows, BATCH_MS)
    ours, theirs = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    assert len(ours) == 1 and ours == theirs
