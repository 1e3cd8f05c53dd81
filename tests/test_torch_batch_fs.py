"""The helpers of ``core/batch.py`` and ``utils/fs.py`` that the port's
first copies left out, against the JAX package's
(``tests/test_batch.py``, ``tests/test_fs_secrets.py``): the same
inputs give the same rows, files and answers."""

import json
import os

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core import batch as jbatch
from data_accelerator_tpu.core.schema import ColType as JColType
from data_accelerator_tpu.core.schema import Schema as JSchema
from data_accelerator_tpu.core.schema import StringDictionary as JStringDictionary
from data_accelerator_tpu.utils import fs as jfs
from data_accelerator_tpu_torch.core import batch as tbatch
from data_accelerator_tpu_torch.core.schema import ColType, Schema, StringDictionary
from data_accelerator_tpu_torch.utils import fs as tfs

from tests.test_batch import HA_SCHEMA_JSON

TS_SCHEMA_JSON = json.dumps({
    "type": "struct",
    "fields": [{"name": "ts", "type": "timestamp", "nullable": False, "metadata": {}},
               {"name": "on", "type": "boolean", "nullable": False, "metadata": {}},
               {"name": "v", "type": "double", "nullable": False, "metadata": {}}],
})


def _rows(rs, n):
    types = ["DoorLock", "WindowLock", "Heating"]
    return [{"deviceDetails": {"deviceId": int(rs.randint(1, 7)),
                               "deviceType": types[rs.randint(3)],
                               "eventTime": 1_700_000_000_000 + int(rs.randint(0, 10_000)),
                               "homeId": int(rs.randint(1, 200)),
                               "status": int(rs.randint(0, 2))}} for _ in range(n)]


@pytest.mark.parametrize("schema_json,max_rows", [(HA_SCHEMA_JSON, None),
                                                   (HA_SCHEMA_JSON, 3),
                                                   (TS_SCHEMA_JSON, None)])
def test_batch_to_rows_equals_the_reference(schema_json, max_rows):
    rs = np.random.RandomState(7)
    if schema_json is TS_SCHEMA_JSON:
        rows = [{"ts": 1_700_000_000_000 + 250 * i, "on": bool(i % 2), "v": 0.5 * i}
                for i in range(5)]
    else:
        rows = _rows(rs, 9)
    out = {}
    for pkg, batch, S, D, C in (("jax", jbatch, JSchema, JStringDictionary, JColType),
                                ("torch", tbatch, Schema, StringDictionary, ColType)):
        s, d = S.from_spark_json(schema_json), D()
        b = batch.batch_from_rows(rows, s, capacity=16, dictionary=d)
        types = {c.name: C(c.ctype.value) for c in s.columns}
        out[pkg] = batch.batch_to_rows(b, d, types, max_rows=max_rows)
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) == (max_rows or len(rows))


def test_empty_batch_equals_the_reference():
    j = jbatch.empty_batch(JSchema.from_spark_json(HA_SCHEMA_JSON), 16, base_ms=1_700_000_000_000)
    t = tbatch.empty_batch(Schema.from_spark_json(HA_SCHEMA_JSON), 16, base_ms=1_700_000_000_000)
    assert t.capacity == j.capacity == 16 and int(t.count()) == int(j.count()) == 0
    assert sorted(t.columns) == sorted(j.columns)
    for name, col in t.columns.items():
        assert col.numpy().dtype == np.asarray(j.columns[name]).dtype, name
        assert not col.any()
    assert float(t.base_ms) == float(j.base_ms)
    assert t.valid.dtype == torch.bool and t.valid.device.type == "cpu"
    assert tbatch.batch_to_rows(t, StringDictionary()) == []


@pytest.mark.parametrize("fs", [jfs, tfs], ids=["jax", "torch"])
def test_write_with_retries_ok(tmp_path, fs):
    p = str(tmp_path / "y.txt")
    assert fs.write_with_timeout_and_retries(p, "data", timeout_s=5) is True
    assert fs.read_text(p) == "data"


@pytest.mark.parametrize("fs", [jfs, tfs], ids=["jax", "torch"])
def test_write_with_retries_raises_after_exhaustion(tmp_path, fs):
    # a directory is not a file to write: every attempt fails
    d = tmp_path / "adir"
    d.mkdir()
    with pytest.raises(OSError):
        fs.write_with_timeout_and_retries(str(d), "data", timeout_s=1, retries=2)


def test_write_with_retries_times_out_a_stuck_write(tmp_path, monkeypatch):
    import threading

    release = threading.Event()
    calls = []

    def stuck(path, content, atomic=True, abort=None):
        calls.append(path)
        release.wait(5)

    monkeypatch.setattr(tfs, "write_text", stuck)
    try:
        with pytest.raises(TimeoutError, match="attempt 2"):
            tfs.write_with_timeout_and_retries(str(tmp_path / "z"), "x", timeout_s=0.05,
                                               retries=2)
    finally:
        release.set()
    assert len(calls) == 2


def test_delete_copy_append_and_wait_equal_the_reference(tmp_path):
    out = {}
    for pkg, fs in (("jax", jfs), ("torch", tfs)):
        root = tmp_path / pkg
        p = root / "f.txt"
        fs.write_text(str(p), "x")
        fs.copy_file(str(p), str(root / "deep" / "g.txt"))
        fs.append_lines(str(root / "log" / "a.txt"), ["one", "two\n"])
        fs.append_lines(str(root / "log" / "a.txt"), ["three"])
        out[pkg] = {
            "copied": fs.read_text(str(root / "deep" / "g.txt")),
            "appended": fs.read_lines(str(root / "log" / "a.txt")),
            "modified": abs(fs.file_modified_ms(str(p)) - os.path.getmtime(p) * 1000) < 1,
            "waited": fs.wait_for_file(str(p), timeout_s=1),
            "absent": fs.wait_for_file(str(root / "never"), timeout_s=0.05, poll_s=0.01),
            "deleted": [fs.delete_path(str(p)), fs.delete_path(str(p)),
                        fs.delete_path(str(root / "deep")), os.path.exists(root / "deep")],
        }
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"copied": "x", "appended": ["one", "two", "three"],
                            "modified": True, "waited": True, "absent": False,
                            "deleted": [True, False, True, False]}
