"""The PyTorch port's slice as a whole against the JAX package: the
single-source alerting flow (BASELINE config 1) plus the config-4 anomaly
query, which runs the anomaly-score kernel's plain version here on the CPU.

Both FlowProcessors see the same numpy columns, batch after batch, 1000
ms apart, so the 5 s window fills and evicts. Rows must match in the
order the reference defines; ints and dictionary ids exactly, floats
(``AvgT``, ``score``) within rtol 1e-5, because the windowed segment sums
add in another order. Metrics and the counts vector must match, except
``Latency-Process`` and ``Decode_RowsPerSec``, which measure wall clock;
the transfer byte count matches too, since both fetch each output's sized
table whole.
"""

import json

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu.udf.samples import anomalyscore as jax_anomalyscore
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.udf.samples import anomalyscore

torch.set_num_threads(2)

IOT_SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceDetails", "type": {"type": "struct", "fields": [
            {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
            {"name": "deviceType", "type": "string", "nullable": False, "metadata": {}},
            {"name": "homeId", "type": "long", "nullable": False, "metadata": {}},
            {"name": "status", "type": "long", "nullable": False, "metadata": {}},
            {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
        ]}, "nullable": False, "metadata": {}},
    ],
})

# BASELINE config 1 (the headline flow), as __graft_entry__ defines it
BASE_TRANSFORM = (
    "--DataXQuery--\n"
    "DoorEvents = SELECT deviceDetails.deviceId AS deviceId, "
    "deviceDetails.deviceType AS deviceType, deviceDetails.status AS status, "
    "deviceDetails.homeId AS homeId, "
    "deviceDetails.temperature AS temperature, eventTimeStamp "
    "FROM DataXProcessedInput\n"
    "--DataXQuery--\n"
    "OpenDoors = SELECT deviceId, eventTimeStamp FROM DoorEvents "
    "WHERE deviceType = 'DoorLock' AND status = 0\n"
    "--DataXQuery--\n"
    "HeatAvg = SELECT deviceId, COUNT(*) AS Cnt, AVG(temperature) AS AvgT "
    "FROM DataXProcessedInput_5seconds GROUP BY deviceId\n"
)
# the config-4 anomaly query on the same stream
ANOMALY_TRANSFORM = (
    "--DataXQuery--\n"
    "Scored = SELECT deviceId, temperature, "
    "anomalyscore(temperature, deviceId) AS score FROM DoorEvents\n"
    "--DataXQuery--\n"
    "AnomalyAlerts = SELECT deviceId, score FROM Scored WHERE score > 0.9\n"
)
OUTPUTS = ["OpenDoors", "HeatAvg", "AnomalyAlerts"]
CAPACITY = 64
BASE_MS = 1_700_000_000_000
TYPES = ["Heating", "WindSpeed", "DoorLock"]


def _conf(transform=BASE_TRANSFORM + ANOMALY_TRANSFORM, **extra):
    conf = {
        "datax.job.name": "TorchSlice",
        "datax.job.input.default.streaming.intervalinseconds": "1",
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": IOT_SCHEMA,
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.transform": transform,
        "datax.job.process.timewindow.DataXProcessedInput_5seconds"
        ".windowduration": "5 seconds",
        "datax.job.process.projection": (
            "current_timestamp() AS eventTimeStamp\nRaw.*"
        ),
    }
    conf.update(extra)
    return conf


def _pair(transform=BASE_TRANSFORM + ANOMALY_TRANSFORM, outputs=OUTPUTS,
          jax_udfs=None, udfs=None):
    jp = JFlowProcessor(
        JSettingDictionary(_conf(transform)), batch_capacity=CAPACITY,
        output_datasets=outputs,
        udfs=jax_udfs if jax_udfs is not None else {"anomalyscore": jax_anomalyscore()},
    )
    tp = FlowProcessor(
        SettingDictionary(_conf(transform)), batch_capacity=CAPACITY,
        output_datasets=outputs,
        udfs=udfs if udfs is not None else {"anomalyscore": anomalyscore()},
        device="cpu",
    )
    return jp, tp


def _type_ids(proc):
    """deviceType ids from the processor's own dictionary."""
    return np.array([proc.dictionary.encode(t) for t in TYPES], np.int32)


def _batch_columns(rs, ids, n):
    """One batch of IoT columns, a few temperatures at x == deviceId and
    far out."""
    cols = {
        "deviceDetails.deviceId": rs.randint(1, 9, n).astype(np.int32),
        "deviceDetails.deviceType": ids[rs.randint(0, 3, n)],
        "deviceDetails.homeId": rs.choice([150, 32, 88], n).astype(np.int32),
        "deviceDetails.status": rs.randint(0, 2, n).astype(np.int32),
        "deviceDetails.temperature": rs.uniform(0, 100, n).astype(np.float32),
    }
    temp = cols["deviceDetails.temperature"]
    temp[:2] = cols["deviceDetails.deviceId"][:2]
    temp[2:4] = [1e5, -1e4]
    return cols


def _assert_same_rows(jrows, trows, what):
    assert len(jrows) == len(trows), (what, len(jrows), len(trows))
    for jr, tr in zip(jrows, trows):
        assert jr.keys() == tr.keys(), what
        for k, jv in jr.items():
            if isinstance(jv, float):
                assert tr[k] == pytest.approx(jv, rel=1e-5), (what, k)
            else:
                assert tr[k] == jv and type(tr[k]) is type(jv), (what, k, jv, tr[k])


def _run_batch(jp, tp, rs, b, n=None):
    n = CAPACITY - 5 * (b % 3) if n is None else n
    ids = _type_ids(jp)
    assert np.array_equal(ids, _type_ids(tp))
    jcols = _batch_columns(rs, ids, n)
    tcols = {c: a.copy() for c, a in jcols.items()}
    t_ms = BASE_MS + 1000 * b + 37
    jh = jp.dispatch_batch(jp.encode_columns(jcols, n), t_ms)
    th = tp.dispatch_batch(tp.encode_columns(tcols, n), t_ms)
    jc = jh.collect_counts().counts
    tc = th.collect_counts().counts
    assert tc.dtype == np.int32
    assert np.array_equal(jc, tc), (b, jc, tc)
    jd, jm = jh.collect()
    td, tm = th.collect()
    return jd, jm, td, tm


def _assert_same_batch(jd, jm, td, tm, b):
    assert set(jd) == set(td)
    for name in jd:
        _assert_same_rows(jd[name], td[name], (b, name))
    assert set(tm) <= set(jm), set(tm) - set(jm)
    for k, v in tm.items():
        if k not in ("Latency-Process", "Decode_RowsPerSec"):
            assert v == jm[k], (b, k, jm[k], v)


def test_slice_matches_jax_over_window_eviction():
    jp, tp = _pair()
    assert jp.dictionary.entries() == tp.dictionary.entries()
    rs = np.random.RandomState(11)
    cnt_per_batch = []
    for b in range(8):
        jd, jm, td, tm = _run_batch(jp, tp, rs, b)
        _assert_same_batch(jd, jm, td, tm, b)
        assert td["AnomalyAlerts"] and td["HeatAvg"]
        cnt_per_batch.append(sum(r["Cnt"] for r in td["HeatAvg"]))
    # the 5 s window spans six batches (both ends inclusive): it fills,
    # then the ring evicts the oldest
    rows = [CAPACITY - 5 * (b % 3) for b in range(8)]
    assert cnt_per_batch[:6] == list(np.cumsum(rows)[:6])
    assert cnt_per_batch[7] == sum(rows[2:8])
    assert tp.udfs["anomalyscore"].launches == 0  # CPU: plain version


def test_window_state_carries_over_from_jax_snapshot():
    jp, tp = _pair()
    rs = np.random.RandomState(5)
    for b in range(5):
        jcols = _batch_columns(rs, _type_ids(jp), CAPACITY)
        jp.process_batch(jp.encode_columns(jcols, CAPACITY), BASE_MS + 1000 * b)
    snap = jp.snapshot_window_state()
    assert tp.restore_window_state(snap)
    assert tp.dictionary.entries() == jp.dictionary.entries()
    for b in range(5, 8):
        jd, jm, td, tm = _run_batch(jp, tp, rs, b)
        _assert_same_batch(jd, jm, td, tm, b)
    # the port's own snapshot has the JAX package's layout and values
    tsnap, jsnap = tp.snapshot_window_state(), jp.snapshot_window_state()
    assert tsnap.keys() == jsnap.keys()
    assert tsnap["slot_counter"] == jsnap["slot_counter"] == 8
    for table, ring in jsnap["rings"].items():
        for c, a in ring["cols"].items():
            assert np.array_equal(tsnap["rings"][table]["cols"][c], a), c
        assert np.array_equal(tsnap["rings"][table]["valid"], ring["valid"])


def test_restore_refuses_a_resized_ring():
    _jp, tp = _pair()
    snap = tp.snapshot_window_state()
    ring = snap["rings"]["DataXProcessedInput"]
    ring["cols"] = {c: a[:, :8] for c, a in ring["cols"].items()}
    ring["valid"] = ring["valid"][:, :8]
    assert not tp.restore_window_state(snap)


def test_sample_udf_tiers_match_jax():
    from data_accelerator_tpu.udf.samples import HelloWorldUdf as JHello
    from data_accelerator_tpu.udf.samples import lastabove as jlast
    from data_accelerator_tpu.udf.samples import scaleby as jscale
    from data_accelerator_tpu_torch.udf.samples import HelloWorldUdf, lastabove, scaleby

    transform = BASE_TRANSFORM + (
        "--DataXQuery--\n"
        "Tiers = SELECT deviceId, scaleby(temperature) AS st, "
        "hello(deviceType) AS hi FROM DoorEvents WHERE status = 1\n"
        "--DataXQuery--\n"
        "Last = SELECT deviceId, lastabove(temperature, eventTimeStamp) AS la "
        "FROM DataXProcessedInput_5seconds GROUP BY deviceId\n"
    )
    outputs = ["Tiers", "Last"]
    jp, tp = _pair(
        transform, outputs,
        jax_udfs={"scaleby": jscale(), "hello": JHello(), "lastabove": jlast()},
        udfs={"scaleby": scaleby(), "hello": HelloWorldUdf(), "lastabove": lastabove()},
    )
    rs = np.random.RandomState(3)
    for b in range(3):
        jd, jm, td, tm = _run_batch(jp, tp, rs, b)
        _assert_same_batch(jd, jm, td, tm, b)
        assert td["Tiers"][0]["hi"].startswith("Hello ")


def test_conf_declared_kernel_udf_loads():
    conf = _conf(**{
        "datax.job.process.jar.udf.anomalyscore.class":
            "data_accelerator_tpu_torch.udf.samples:anomalyscore",
    })
    proc = FlowProcessor(
        SettingDictionary(conf), batch_capacity=CAPACITY,
        output_datasets=OUTPUTS, device="cpu",
    )
    rs = np.random.RandomState(1)
    datasets, metrics = proc.process_batch(
        proc.encode_columns(_batch_columns(rs, _type_ids(proc), 10), 10), BASE_MS
    )
    assert metrics["Output_AnomalyAlerts_Events_Count"] == len(datasets["AnomalyAlerts"])
    assert proc.udfs["anomalyscore"].launches == 0


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineException, match="no CUDA device"):
        FlowProcessor(SettingDictionary(_conf()), batch_capacity=CAPACITY,
                      output_datasets=OUTPUTS)


@pytest.mark.parametrize("key,value,feature", [
    ("datax.job.process.numchips", "4", "mesh"),
    ("datax.job.input.sources.weather.blobschemafile", IOT_SCHEMA, "multi-source"),
    ("datax.job.process.statetable.peaks.schema", "deviceId long", "state tables"),
    ("datax.job.input.default.referencedata.homes.path", "homes.csv", "reference data"),
    ("datax.job.process.debug.nans", "true", "debug guards"),
    ("datax.job.process.compile.manifest", "{}", "AOT warm-up"),
    ("datax.job.process.state.filteringest", "true", "partitioned state"),
])
def test_unported_features_raise_by_name(key, value, feature):
    with pytest.raises(EngineException, match=feature):
        FlowProcessor(SettingDictionary(_conf(**{key: value})),
                      batch_capacity=CAPACITY, output_datasets=OUTPUTS,
                      device="cpu")
