"""The port's batch host and blob-pointer input, the mirror of
``test_batchhost_blobpointer.py`` on ``data_accelerator_tpu_torch``:
prefix expansion, the batch conf, ``BatchHost`` end to end on the CPU
(``device="cpu"``) with its tracker file, and ``BlobPointerSource``.
"""

import gzip
import json
import os
from datetime import datetime, timezone

from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.runtime.batchhost import (
    BatchHost,
    get_batch_blobs_conf,
    get_input_blob_path_prefixes,
)
from data_accelerator_tpu_torch.runtime.sources import BlobPointerSource, FileSource

SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
        {"name": "temperature", "type": "double", "nullable": False, "metadata": {}},
    ],
})


# -- path prefix expansion (BlobBatchingHost.scala:28-53) -----------------

def test_prefix_expansion_daily():
    start = datetime(2024, 3, 1, tzinfo=timezone.utc)
    out = get_input_blob_path_prefixes(
        "/data/{yyyy-MM-dd}/flow1", start, 2 * 86400, 86400
    )
    assert [p for p, _ in out] == [
        "/data/2024-03-01/flow1",
        "/data/2024-03-02/flow1",
        "/data/2024-03-03/flow1",
    ]


def test_prefix_expansion_dedupes_partitions():
    start = datetime(2024, 3, 1, tzinfo=timezone.utc)
    # hourly increment over one day with a daily pattern -> one partition
    out = get_input_blob_path_prefixes(
        "/data/{yyyy-MM-dd}", start, 3600 * 5, 3600
    )
    assert [p for p, _ in out] == ["/data/2024-03-01"]


def test_prefix_expansion_no_pattern_passthrough():
    out = get_input_blob_path_prefixes(
        "/data/static", datetime(2024, 3, 1, tzinfo=timezone.utc), 86400, 3600
    )
    assert len(out) == 1 and out[0][0] == "/data/static"


def test_batch_blobs_conf_parsing():
    d = SettingDictionary({
        "datax.job.input.batch.blob.0.path": "/a/{yyyy-MM-dd}/x",
        "datax.job.input.batch.blob.0.starttime": "2024-03-01T00:00:00Z",
        "datax.job.input.batch.blob.0.endtime": "2024-03-02T00:00:00Z",
        "datax.job.input.batch.blob.0.partitionincrement": "1440",
        "datax.job.input.batch.blob.1.path": "/b/y",
    })
    blobs = get_batch_blobs_conf(d)
    assert len(blobs) == 2
    assert blobs[0]["partitionincrement"] == "1440"
    assert blobs[1]["path"] == "/b/y"


# -- end-to-end batch run -------------------------------------------------

def _write_events(path, rows, gz=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path, "wt", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _batch_conf(tmp_path, transform_path):
    return SettingDictionary({
        "datax.job.name": "BatchFlow",
        "datax.job.input.default.inputtype": "file",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": transform_path,
        "datax.job.process.projection": "Raw.*",
        "datax.job.process.batchcapacity": "64",
        "datax.job.input.batch.blob.0.path":
            str(tmp_path / "in" / "{yyyy-MM-dd}" / "*.json*"),
        "datax.job.input.batch.blob.0.starttime": "2024-03-01T00:00:00Z",
        "datax.job.input.batch.blob.0.endtime": "2024-03-02T00:00:00Z",
        "datax.job.input.batch.blob.0.partitionincrement": "1440",
        "datax.job.input.batch.blob.trackerfile":
            str(tmp_path / "tracker.txt"),
        "datax.job.output.Hot.blob.group.main.folder": str(tmp_path / "out"),
        "datax.job.output.Hot.blob.compressiontype": "none",
    })


def test_batch_host_end_to_end(tmp_path):
    transform = tmp_path / "flow.transform"
    transform.write_text(
        "--DataXQuery--\n"
        "Hot = SELECT deviceId, temperature FROM DataXProcessedInput "
        "WHERE temperature > 50\n"
    )
    _write_events(
        str(tmp_path / "in" / "2024-03-01" / "a.json"),
        [{"deviceId": 1, "temperature": 80.0}, {"deviceId": 2, "temperature": 10.0}],
    )
    _write_events(
        str(tmp_path / "in" / "2024-03-02" / "b.json.gz"),
        [{"deviceId": 3, "temperature": 99.0}],
        gz=True,
    )
    host = BatchHost(_batch_conf(tmp_path, str(transform)), device="cpu")
    totals = host.run()
    assert totals["Batch_Files_Count"] == 2
    out_files = []
    for root, _d, files in os.walk(tmp_path / "out"):
        out_files += [os.path.join(root, f) for f in files]
    rows = []
    for f in out_files:
        rows += [json.loads(x) for x in open(f).read().splitlines()]
    assert sorted(r["deviceId"] for r in rows) == [1, 3]

    # recurring rerun: tracker makes it a no-op
    host2 = BatchHost(_batch_conf(tmp_path, str(transform)), device="cpu")
    totals2 = host2.run()
    assert totals2["Batch_Files_Count"] == 0


# -- blob pointer input ---------------------------------------------------

def test_blob_pointer_source(tmp_path):
    data = tmp_path / "store" / "src1" / "events_2024-03-01T12_30_00.json"
    _write_events(str(data), [{"deviceId": 7, "temperature": 55.5}])
    ptr_file = tmp_path / "pointers.json"
    ptr_file.write_text(
        json.dumps({"BlobPath": str(data)}) + "\n"
        + json.dumps({"BlobPath": str(tmp_path / "store" / "unknown" / "x.json")})
        + "\n"
    )
    src = BlobPointerSource(
        FileSource([str(ptr_file)], name="pointers"),
        sources={"src1": "targetA"},
        source_id_regex=r"store/([\w\d]+)/[^/]*$",
    )
    rows, offsets = src.poll(10)
    assert len(rows) == 1
    info = rows[0]["__DataX_FileInfo"]
    assert info["sourceId"] == "src1"
    assert info["target"] == "targetA"
    # file time parsed from ..._2024-03-01T12_30_00... (underscores -> colons)
    assert info["fileTimeMs"] == int(
        datetime(2024, 3, 1, 12, 30, tzinfo=timezone.utc).timestamp() * 1000
    )
    assert src.out_of_scope == 1
    assert offsets  # inner file-source offsets surface


def test_blob_pointer_file_time_format(tmp_path):
    data = tmp_path / "s" / "acct" / "20240301-1230.json"
    _write_events(str(data), [{"deviceId": 1, "temperature": 1.0}])
    ptr = tmp_path / "p.json"
    ptr.write_text(json.dumps({"BlobPath": str(data)}) + "\n")
    src = BlobPointerSource(
        FileSource([str(ptr)], name="pointers"),
        sources={"acct": "t"},
        source_id_regex=r"/s/([\w\d]+)/",
        file_time_regex=r"(\d{8}-\d{4})",
        file_time_format="yyyyMMdd-HHmm",
    )
    rows, _ = src.poll(10)
    assert rows[0]["__DataX_FileInfo"]["fileTimeMs"] == int(
        datetime(2024, 3, 1, 12, 30, tzinfo=timezone.utc).timestamp() * 1000
    )
