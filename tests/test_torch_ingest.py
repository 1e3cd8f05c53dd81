"""The port's ingest against the JAX package's: its own copy of the native
decoder (``data_accelerator_tpu_torch/csrc/decoder.cpp``), built with g++
here for real, fed the same bytes as the JAX package's decoder, and the
whole config-1 plus anomaly flow fed the same JSON bytes through both
``FlowProcessor.encode_json_bytes``, batch after batch.

Decoder outputs (columns, validity, packed matrices, dictionary ids,
counts) must be identical, since both run the same C++ on the same bytes.
Flow rows: ints and dictionary ids exact, floats within rtol 1e-5 (the
tolerance of ``test_torch_flow.py``: windowed segment sums add in another
order). Metrics must match except ``Latency-Process`` and
``Decode_RowsPerSec``, which measure wall clock.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.core.schema import Schema as JSchema
from data_accelerator_tpu.core.schema import StringDictionary as JStringDictionary
from data_accelerator_tpu.native import NativeDecoder as JNativeDecoder
from data_accelerator_tpu.native import PackedBufferPool as JPackedBufferPool
from data_accelerator_tpu.runtime.kafka_wire import _crc32c, encode_record_batch
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu.udf.samples import anomalyscore as jax_anomalyscore
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.core.schema import Schema, StringDictionary
from data_accelerator_tpu_torch.kernels import build
from data_accelerator_tpu_torch.native import (
    NativeDecoder,
    PackedBufferPool,
    UnsupportedCodecError,
    native_crc32c,
)
from data_accelerator_tpu_torch.native import decoder as decoder_mod
from data_accelerator_tpu_torch.runtime.processor import (
    FlowProcessor,
    PackedRaw,
    pack_from_matrix,
    pack_raw,
    packed_raw_layout,
)
from data_accelerator_tpu_torch.udf.samples import anomalyscore
from test_torch_flow import (
    ANOMALY_TRANSFORM,
    BASE_MS,
    BASE_TRANSFORM,
    IOT_SCHEMA,
    OUTPUTS,
    _as_jax_metrics,
    _assert_same_rows,
    _conf,
    _jax_counts,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECODER_SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceDetails", "type": {"type": "struct", "fields": [
            {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
            {"name": "deviceType", "type": "string", "nullable": False, "metadata": {}},
            {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
            {"name": "online", "type": "boolean", "nullable": False, "metadata": {}},
        ]}, "nullable": False, "metadata": {}},
        {"name": "eventTime", "type": "timestamp", "nullable": True, "metadata": {}},
    ],
})


def _line(i, dtype="DoorLock", ts=None, temp=None):
    row = {"deviceDetails": {"deviceId": i, "deviceType": dtype,
                             "temperature": 20.5 + i if temp is None else temp,
                             "online": i % 2 == 0}}
    if ts is not None:
        row["eventTime"] = ts
    return json.dumps(row).encode()


def _lines(*rows):
    return b"\n".join(rows) + b"\n"


# payloads of the reference decoder's own tests: plain, malformed and
# partial lines, ISO, garbage and edge-case string timestamps
PAYLOADS = {
    "basic": _lines(*[_line(i, t, 1_700_000_000 + i) for i, t in
                      enumerate(["DoorLock", "Heating", "DoorLock"])]),
    "malformed": _lines(_line(7), b"{not json}", _line(8), b"", _line(9)),
    "truncated": _lines(_line(1)) + b'{"deviceDetails": {"deviceId"',
    "iso": _lines(_line(1, ts="2023-11-14T22:13:20.500Z"),
                  _line(2, ts="2023-11-14T22:13:20Z")),
    "bad_timestamps": _lines(
        *[_line(i, ts=ts) for i, ts in enumerate(
            [1_700_000_000, "not-a-date", "1700000123", "NaN", "inf", "0x1A",
             "1e5", "-5", "", ".", "1.2.3", " 1700000123 ", "1700000123456",
             "1700000123.5"])]),
    "strings": _lines(*[_line(i, f"T{i % 5}", temp=i / 3.0) for i in range(40)]),
}


def _decoders(threads=None, preseed=()):
    jd, td = JStringDictionary(), StringDictionary()
    for s in preseed:
        assert jd.encode(s) == td.encode(s)
    jdec = JNativeDecoder(JSchema.from_spark_json(DECODER_SCHEMA), jd, threads=threads)
    tdec = NativeDecoder(Schema.from_spark_json(DECODER_SCHEMA), td, threads=threads)
    return (jdec, jd), (tdec, td)


def test_port_decoder_builds():
    """The port's decoder builds from its own copy of the source, with
    g++, into _build/: a failed build would fail every ingest path."""
    path = build.build_host(decoder_mod.SOURCE)
    assert path.parent == build.BUILD_DIR and path.exists()
    assert build.source_path(decoder_mod.SOURCE, ".cpp") == (
        build.CSRC_DIR / "decoder.cpp")
    lib = decoder_mod._load()
    assert lib is decoder_mod._load()
    assert native_crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_decoder_source_is_the_reference_source_byte_for_byte():
    with open(os.path.join(ROOT, "native", "decoder.cpp"), "rb") as f:
        ref = f.read()
    assert (build.CSRC_DIR / "decoder.cpp").read_bytes() == ref


def test_host_build_errors_are_build_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "bad.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ exit"):
        build.load_host(src)
    with pytest.raises(build.KernelBuildError, match=r"\.cpp"):
        build.build_host(tmp_path / "bad.cu")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ not found"):
        build.build_host(src)


def test_decoder_load_raises_what_the_build_raised(monkeypatch):
    def broken(source):
        raise build.KernelBuildError("g++ not found on PATH")

    monkeypatch.setattr(decoder_mod, "_lib", None)
    monkeypatch.setattr(build, "load_host", broken)
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ not found"):
        NativeDecoder(Schema.from_spark_json(DECODER_SCHEMA), StringDictionary())


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("threads", [1, 4])
def test_row_decode_matches_jax_decoder(name, threads):
    (jdec, jd), (tdec, td) = _decoders(threads, preseed=["Heating"])
    data = PAYLOADS[name]
    ja, jv, jr, jc = jdec.decode(data, 32)
    ta, tv, tr, tc = tdec.decode(data, 32)
    assert (tr, tc) == (jr, jc)
    assert np.array_equal(tv, jv)
    assert ta.keys() == ja.keys()
    for c in ja:
        assert ta[c].dtype == ja[c].dtype and np.array_equal(ta[c], ja[c]), c
    assert tdec.last_bad_timestamps == jdec.last_bad_timestamps
    assert tdec.last_shards == jdec.last_shards == threads
    assert td.entries() == jd.entries()


def _packed(dec, pool, data, fmt, base_ms=BASE_MS):
    mat = pool.acquire()
    mat = mat.numpy() if isinstance(mat, torch.Tensor) else mat
    mat.fill(-1)  # a dirty pool matrix
    n_cols = len(dec.schema.columns)
    col_rows = list(range(n_cols))
    if fmt == "kafka":
        out = dec.decode_kafka_packed(data, mat, col_rows, n_cols, base_ms)
    else:
        out = dec.decode_packed(data, mat, col_rows, n_cols, base_ms)
    return out, mat


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("threads", [1, 4])
def test_packed_decode_matches_jax_decoder(name, threads):
    (jdec, jd), (tdec, td) = _decoders(threads)
    data = PAYLOADS[name]
    jout, jmat = _packed(jdec, JPackedBufferPool(6, 32), data, "jsonl")
    tout, tmat = _packed(tdec, PackedBufferPool(6, 32), data, "jsonl")
    assert tout == jout
    assert np.array_equal(tmat, jmat)  # bitcast floats, rebased timestamps
    assert tdec.last_bad_timestamps == jdec.last_bad_timestamps
    assert td.entries() == jd.entries()


def _values(n, start=0):
    return [
        json.dumps({"deviceDetails": {"deviceId": start + i,
                                      "deviceType": f"T{(start + i) % 3}",
                                      "temperature": 20.0 + start + i,
                                      "online": (start + i) % 2 == 0},
                    "eventTime": 1_700_000_000 + start + i}).encode()
        for i in range(n)
    ]


def _control_batch(base):
    """A control batch (attributes bit 5), CRC recomputed so it is valid."""
    b = bytearray(encode_record_batch(base, _values(2, start=base)))
    b[21:23] = struct.pack(">h", 0x20)
    b[17:21] = struct.pack(">I", _crc32c(bytes(b[21:])))
    return bytes(b)


def _kafka_blob():
    vals = _values(12)
    vals.insert(3, b"{not json")  # malformed value
    vals.insert(7, b"")  # empty value
    corrupt = bytearray(encode_record_batch(14, _values(4, start=14)))
    corrupt[80] ^= 0xFF  # a record byte flipped: the CRC now mismatches
    tail = encode_record_batch(30, _values(4, start=30))[:40]  # split batch
    return (encode_record_batch(0, vals[:8], timestamp_ms=1)
            + bytes(corrupt) + _control_batch(18)
            + encode_record_batch(8, vals[8:], timestamp_ms=2) + tail)


@pytest.mark.parametrize("threads", [1, 4])
def test_kafka_packed_decode_matches_jax_decoder(threads):
    (jdec, jd), (tdec, td) = _decoders(threads)
    data = _kafka_blob()
    (jrows, jstats), jmat = _packed(jdec, JPackedBufferPool(6, 32), data, "kafka")
    (trows, tstats), tmat = _packed(tdec, PackedBufferPool(6, 32), data, "kafka")
    assert (trows, tstats) == (jrows, jstats)
    assert trows == 12
    assert tstats["malformed"] == 2 and tstats["corrupt_batches"] == 1
    assert tstats["control_batches"] == 1
    assert np.array_equal(tmat, jmat)
    assert td.entries() == jd.entries()
    assert native_crc32c(data) == _crc32c(data)


def test_kafka_packed_decode_sharded_over_many_records():
    """>= 8192 records: the walker's sharded value decode gives the rows
    and dictionary of one shard, and the JAX package's at 4 shards."""
    vals = _values(9000)
    data = b"".join(encode_record_batch(i, vals[i: i + 1000])
                    for i in range(0, 9000, 1000))
    results = []
    for threads in (1, 4):
        (jdec, jd), (tdec, td) = _decoders(threads)
        jout, jmat = _packed(jdec, JPackedBufferPool(6, 9000), data, "kafka")
        tout, tmat = _packed(tdec, PackedBufferPool(6, 9000), data, "kafka")
        assert tout == jout and np.array_equal(tmat, jmat)
        assert td.entries() == jd.entries()
        valid = tmat[5] != 0
        results.append([td.decode(int(i)) for i in tmat[1][valid]])
    assert results[0] == results[1]


def test_kafka_compressed_batch_is_refused_by_codec():
    batch = bytearray(encode_record_batch(0, _values(2)))
    batch[21:23] = struct.pack(">h", 3)  # lz4 codec bits
    (_jdec, _jd), (tdec, _td) = _decoders()
    with pytest.raises(UnsupportedCodecError, match="lz4"):
        _packed(tdec, PackedBufferPool(6, 8), bytes(batch), "kafka")


def test_packed_decode_refuses_a_matrix_it_does_not_fit():
    (_j, _jd), (tdec, _td) = _decoders()
    with pytest.raises(ValueError, match="C-contiguous"):
        tdec.decode_packed(b"", np.zeros((6, 8), np.int64), range(5), 5, 0)
    with pytest.raises(ValueError, match="do not fit"):
        tdec.decode_packed(b"", np.zeros((5, 8), np.int32), range(5), 5, 0)


def test_pool_matrices_are_aligned_and_gated_on_their_copy():
    pool = PackedBufferPool(3, 40)
    m = pool.acquire()
    assert m.dtype == torch.int32 and m.shape == (3, 40)
    assert m.numpy().ctypes.data % 64 == 0 and m.is_contiguous()

    class Copy:  # a CUDA event's query(), without a card
        done = False

        def query(self):
            return self.done

    copied = Copy()
    pool.release(m, copied)
    other = pool.acquire()  # the copy is in flight: a new matrix
    assert other is not m and pool.alloc_count == 2
    copied.done = True
    assert pool.acquire() is m
    assert pool.reuse_count == 1 and pool.take_reuse_count() == 1
    assert pool.take_reuse_count() == 0


def test_pack_raw_and_pack_from_matrix_match_the_reference_layout():
    rs = np.random.RandomState(2)
    cols = {"a": rs.randint(0, 9, 8).astype(np.int64),
            "t": rs.uniform(0, 1, 8),
            "f": rs.uniform(0, 1, 8).astype(np.float32),
            "b": rs.uniform(size=8) < 0.5}
    valid = np.arange(8) < 5
    from data_accelerator_tpu.runtime.processor import pack_raw as jpack_raw

    jp = jpack_raw(cols, valid, to_device=False)
    tp = pack_raw(cols, valid)
    assert tp.layout == jp.layout
    assert np.array_equal(tp.data.numpy(), jp.data)
    for raw in (tp, pack_from_matrix(jp.data, jp.layout)):
        t = raw.unpack()
        assert t.cols["t"].dtype == torch.float32
        assert np.array_equal(t.cols["t"].numpy(), cols["t"].astype(np.float32))
        assert np.array_equal(t.cols["b"].numpy(), cols["b"])
        assert np.array_equal(t.valid.numpy(), valid)
    assert packed_raw_layout({"x": "long", "y": "double", "z": "boolean"}) == (
        ("x", "i32"), ("y", "f32"), ("z", "bool"))


# -- the processor's ingest -------------------------------------------------
KV_SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "deviceType", "type": "string", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
]})


def _kv_conf(extra=None):
    conf = {
        "datax.job.name": "TorchIngest",
        "datax.job.input.default.inputtype": "kafka",
        "datax.job.input.default.blobschemafile": KV_SCHEMA,
        "datax.job.process.transform": (
            "--DataXQuery--\nOut = SELECT deviceId, deviceType, temperature "
            "FROM DataXProcessedInput\n"),
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.projection": (
            "current_timestamp() AS eventTimeStamp\nRaw.*"),
    }
    conf.update(extra or {})
    return conf


def _kv_proc(capacity=16, extra=None):
    return FlowProcessor(SettingDictionary(_kv_conf(extra)),
                         batch_capacity=capacity, output_datasets=["Out"],
                         device="cpu")


def _kv_blob(n, start=0):
    return b"\n".join(
        json.dumps({"deviceId": start + i, "deviceType": "a",
                    "temperature": 1.0 + i}).encode() for i in range(n)
    ) + b"\n"


def test_packed_pool_reuse_and_in_flight_protection():
    """A pool matrix acquired for a batch is never handed to a new decode
    until that batch lands (on the CPU the step reads it in place); after
    the landing, and after an abandon, the next decode reuses it."""
    proc = _kv_proc()
    blob = _kv_blob(4)
    r1 = proc.encode_json_bytes(blob, BASE_MS, to_device=False)
    pool, m1 = r1.ingest_slot
    assert isinstance(r1, PackedRaw) and r1.data is m1 and not pool.pin
    r2 = proc.encode_json_bytes(blob, BASE_MS + 1000, to_device=False)
    m2 = r2.ingest_slot[1]
    assert m1 is not m2
    assert pool.alloc_count == 2 and pool.reuse_count == 0

    h1 = proc.dispatch_batch(r1, BASE_MS)
    h1.collect_counts()
    r_mid = proc.encode_json_bytes(blob, BASE_MS, to_device=False)
    # the counts alone do not land the batch
    assert all(r_mid.ingest_slot[1] is not m for m in (m1, m2))
    h1.collect_tables()  # lands -> gives m1 back
    r3 = proc.encode_json_bytes(blob, BASE_MS + 2000, to_device=False)
    assert r3.ingest_slot[1] is m1
    assert pool.reuse_count == 1

    h2 = proc.dispatch_batch(r2, BASE_MS + 1000)
    h2.abandon()  # the failure-requeue path gives m2 back too
    r4 = proc.encode_json_bytes(blob, BASE_MS + 3000, to_device=False)
    assert r4.ingest_slot[1] is m2
    _d, m = proc.dispatch_batch({"default": r3}, BASE_MS + 2000).collect_tables()
    assert m["Decode_BufferReuse_Count"] == 2.0
    assert m["Decode_Shards"] >= 1 and m["Decode_RowsPerSec"] > 0
    assert proc.last_decoder_path == "native-sharded"


def test_failed_dispatch_gives_the_matrix_back(monkeypatch):
    proc = _kv_proc()
    raw = proc.encode_json_bytes(_kv_blob(2), BASE_MS, to_device=False)
    pool, mat = raw.ingest_slot

    def broken(*args, **kwargs):
        raise RuntimeError("step failed")

    monkeypatch.setattr(proc, "_step", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        proc.dispatch_batch(raw, BASE_MS)
    assert proc.encode_json_bytes(_kv_blob(2), BASE_MS).ingest_slot[1] is mat


def test_decoderthreads_conf_reaches_decoder(monkeypatch):
    proc = _kv_proc(extra={"datax.job.process.ingest.decoderthreads": "3"})
    assert proc.decoder_threads == 3
    monkeypatch.delenv("DATAX_DECODER_THREADS", raising=False)
    proc.encode_json_bytes(_kv_blob(1), BASE_MS, to_device=False)
    dec = proc._native_decoders["default"]
    assert dec.threads == 3 and dec.shard_count() == 3
    assert proc._decode_shards == 3
    monkeypatch.setenv("DATAX_DECODER_THREADS", "2")
    assert dec.shard_count() == 2  # the operator's override wins
    with pytest.raises(EngineException, match="decoderthreads"):
        _kv_proc(extra={"datax.job.process.ingest.decoderthreads": "0"})


def test_pipeline_conf_validation_and_defaults():
    proc = _kv_proc()
    assert proc.pipeline_depth == 2
    assert proc.sized_transfer and proc.output_slots_enabled
    with pytest.raises(EngineException, match="pipeline.depth"):
        _kv_proc(extra={"datax.job.process.pipeline.depth": "0"})
    proc = _kv_proc(extra={"datax.job.process.pipeline.depth": "4",
                           "datax.job.process.pipeline.sizedtransfer": "false",
                           "datax.job.process.pipeline.outputslots": "false"})
    assert proc.pipeline_depth == 4
    assert not proc.sized_transfer and not proc.output_slots_enabled


def test_row_layout_kafka_and_unknown_source_are_refused():
    """Row-layout kafka-v2 (``packed=False``) runs through the port's
    ``kafka_wire`` walker and matches the JAX package's columns and
    counters, corrupt and malformed records included; an unknown source
    is refused."""
    proc = _kv_proc()
    jproc = JFlowProcessor(JSettingDictionary(_kv_conf()), batch_capacity=16,
                           output_datasets=["Out"])
    blob = _kafka_blob()
    got = proc.encode_json_bytes(blob, BASE_MS, packed=False, fmt="kafka-v2")
    want = jproc.encode_json_bytes(blob, BASE_MS, packed=False, fmt="kafka-v2")
    assert proc.last_decoder_path == jproc.last_decoder_path == "native-mt"
    assert set(got.cols) == set(want.cols)
    for c in want.cols:
        assert np.array_equal(got.cols[c].numpy(), np.asarray(want.cols[c])), c
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert proc.ingest_stats == jproc.ingest_stats
    assert proc.ingest_stats["CorruptBatch"] == 1
    with pytest.raises(EngineException, match="unknown source"):
        proc.encode_json_bytes(_kv_blob(1), BASE_MS, source="weather")


def test_kafka_compressed_batch_is_refused_by_the_processor():
    batch = bytearray(encode_record_batch(0, [b'{"deviceId": 1}']))
    batch[21:23] = struct.pack(">h", 3)
    proc = _kv_proc()
    with pytest.raises(UnsupportedCodecError, match="lz4"):
        proc.encode_json_bytes(bytes(batch), BASE_MS, fmt="kafka-v2")
    # the matrix went back to the pool
    assert len(proc._ingest_pools["default"]._free) == 1


# -- the slice as a whole from bytes ----------------------------------------
TYPES = np.array(["Heating", "WindSpeed", "DoorLock"])


def _payload(rs, n, malformed=0):
    """bench.py::make_json_payload's distribution (deviceId 1-8, three
    device types, ~1% door-lock alerts, temperatures 0-100 at three
    decimals), a few temperatures at x == deviceId and far out, and
    ``malformed`` broken lines."""
    is_door = rs.uniform(size=n) < 0.02
    dtype_col = np.where(is_door, 2, rs.randint(0, 2, n))
    status = np.where(is_door & (rs.uniform(size=n) < 0.5), 0, 1)
    device_id = rs.randint(1, 9, n)
    temp = rs.uniform(0, 100, n)
    temp[:2] = device_id[:2]
    temp[2] = 1e5
    lines = [
        '{"deviceDetails":{"deviceId":%d,"deviceType":"%s","homeId":150,'
        '"status":%d,"temperature":%.3f},"eventTimeStamp":%d}'
        % (device_id[i], TYPES[dtype_col[i]], status[i], temp[i], BASE_MS + i)
        for i in range(n)
    ]
    for k in range(malformed):
        lines.insert(5 + 7 * k, '{"deviceDetails": {"deviceId": ')
    return ("\n".join(lines) + "\n").encode()


def _kafka(payload):
    vals = payload.rstrip(b"\n").split(b"\n")
    return b"".join(encode_record_batch(i, vals[i: i + 10], timestamp_ms=i)
                    for i in range(0, len(vals), 10))


CAPACITY = 64


def _flow_pair(extra=None, capacity=CAPACITY):
    conf = _conf(BASE_TRANSFORM + ANOMALY_TRANSFORM, **(extra or {}))
    jp = JFlowProcessor(JSettingDictionary(conf), batch_capacity=capacity,
                        output_datasets=OUTPUTS,
                        udfs={"anomalyscore": jax_anomalyscore()})
    tp = FlowProcessor(SettingDictionary(conf), batch_capacity=capacity,
                       output_datasets=OUTPUTS,
                       udfs={"anomalyscore": anomalyscore()}, device="cpu")
    return jp, tp


def _same_batch(jh, th, b):
    jc, tc = jh.collect_counts().counts, th.collect_counts().counts
    assert np.array_equal(jc, _jax_counts(tc, jc, th.proc)), (b, jc, tc)
    jd, jm = jh.collect_tables()
    td, tm = th.collect_tables()
    tm = _as_jax_metrics(tm, th.proc)
    assert set(jd) == set(td)
    for name in jd:
        _assert_same_rows(jd[name], td[name], (b, name))
    assert set(tm) <= set(jm), set(tm) - set(jm)
    for k, v in tm.items():
        if k not in ("Latency-Process", "Decode_RowsPerSec"):
            assert v == jm[k], (b, k, jm[k], v)
    return td, tm


@pytest.mark.parametrize("fmt", ["jsonl", "kafka-v2"])
@pytest.mark.parametrize("threads", ["1", "4"])
def test_flow_from_bytes_matches_jax(fmt, threads):
    """Config 1 plus the anomaly query, fed the same bytes batch after
    batch (1000 ms apart, so the 5 s window fills and evicts), through
    the packed native path of both packages."""
    jp, tp = _flow_pair({"datax.job.process.ingest.decoderthreads": threads})
    rs = np.random.RandomState(7)
    seen = {n: 0 for n in OUTPUTS}
    for b in range(8):
        payload = _payload(rs, CAPACITY - 5 * (b % 3), malformed=b % 2)
        data = _kafka(payload) if fmt == "kafka-v2" else payload
        t_ms = BASE_MS + 1000 * b + 37
        jraw = jp.encode_json_bytes(data, t_ms, fmt=fmt)
        traw = tp.encode_json_bytes(data, t_ms, fmt=fmt)
        assert isinstance(traw, PackedRaw)
        assert jp.dictionary.entries() == tp.dictionary.entries()
        td, tm = _same_batch(jp.dispatch_batch(jraw, t_ms),
                             tp.dispatch_batch(traw, t_ms), b)
        assert tm["Decode_Shards"] == float(threads)
        if b % 2:
            assert tm["Input_malformed_rows_Count"] == 1.0
        for n in OUTPUTS:
            seen[n] += len(td[n])
    assert all(seen.values()), seen
    assert tp.malformed_rows_total == jp.malformed_rows_total == 4


def test_flow_from_bytes_row_layout_matches_jax():
    jp, tp = _flow_pair()
    rs = np.random.RandomState(9)
    for b in range(3):
        data = _payload(rs, CAPACITY, malformed=1)
        t_ms = BASE_MS + 1000 * b
        jraw = jp.encode_json_bytes(data, t_ms, packed=False)
        traw = tp.encode_json_bytes(data, t_ms, packed=False)
        assert tp.last_decoder_path == jp.last_decoder_path == "native-mt"
        _same_batch(jp.dispatch_batch(jraw, t_ms), tp.dispatch_batch(traw, t_ms), b)


def test_flow_from_bytes_with_decode_ahead_and_background_landing():
    """The depth-2 loop of a pipelined host: batch N+1 decodes (to the
    host) while up to two batches are in flight, a batch retires on its
    counts alone, and its tables land on one background thread. Rows and
    metrics equal the JAX package's sequential run of the same bytes."""
    from concurrent.futures import ThreadPoolExecutor

    jp, tp = _flow_pair()
    rs = np.random.RandomState(4)
    payloads = [_payload(rs, CAPACITY - 3 * b) for b in range(8)]
    golden = []
    for b, data in enumerate(payloads):
        h = jp.dispatch_batch(jp.encode_json_bytes(data, BASE_MS + 1000 * b),
                              BASE_MS + 1000 * b)
        golden.append((h.collect_counts().counts, *h.collect_tables()))
    pending, landed = [], []

    def retire(h):
        landed.append((h.collect_counts().counts,
                       landing.submit(h.collect_tables)))
        # backpressure as in a pipelined host: at most `depth` landings
        # outstanding
        for _c, fut in landed[:-tp.pipeline_depth]:
            fut.result(timeout=60)

    with ThreadPoolExecutor(1, thread_name_prefix="landing") as landing:
        raw = tp.encode_json_bytes(payloads[0], BASE_MS, to_device=False)
        for b in range(8):
            pending.append(tp.dispatch_batch(raw, BASE_MS + 1000 * b))
            if len(pending) > tp.pipeline_depth:
                retire(pending.pop(0))
            if b + 1 < 8:
                raw = tp.encode_json_bytes(payloads[b + 1],
                                           BASE_MS + 1000 * (b + 1),
                                           to_device=False)
        for h in pending:
            retire(h)
        results = [(c, *f.result(timeout=60)) for c, f in landed]
    # on the CPU a matrix goes back at its batch's landing, which runs on
    # the landing thread, so up to `depth` landings may still hold theirs
    # (on CUDA it goes back at the counts, and chip_smoke.py holds the
    # pool to depth + 1)
    pool = tp._ingest_pools["default"]
    assert pool.alloc_count <= 2 * tp.pipeline_depth + 1
    assert pool.reuse_count == 8 - pool.alloc_count
    for b, ((jc, jd, jm), (tc, td, tm)) in enumerate(zip(golden, results)):
        assert np.array_equal(jc, _jax_counts(tc, jc, tp)), b
        tm = _as_jax_metrics(tm, tp)
        for name in OUTPUTS:
            _assert_same_rows(jd[name], td[name], (b, name))
        for k in ("Transfer_D2HBytes", "Transfer_Efficiency",
                  "Output_AnomalyAlerts_Events_Count"):
            assert tm[k] == jm[k], (b, k)
    assert sum(m.get("Decode_BufferReuse_Count", 0) for _c, _d, m in results) == (
        8 - pool.alloc_count)
