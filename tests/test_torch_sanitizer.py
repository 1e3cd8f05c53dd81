"""The port's buffer sanitizer (``runtime/sanitizer.py``, runtime DX805)
against the JAX package's, the mirror of ``tests/test_racecheck.py``'s
dynamic cases and the sanitizer arming of ``tests/test_recovery.py``.

- Unit cases equal to the reference's: the sentinel-run threshold, the
  DX800 bad/clean twins driven through each package's real pool.
- An armed processor runs batches silently and exports
  ``Sanitizer_GuardedViews_Count`` in both packages.
- The seeded use-after-release: a column view of a pooled ingest matrix
  kept past its release reads the poison, and the scan reports DX805
  with ``Sanitizer_PoisonHit_Count`` 1, in both packages.
- The seeded aliasing snapshot: the port's ``_copy_out`` with its clone
  dropped hands back the live ring, and ``check_snapshot`` convicts it;
  so does a snapshot sharing memory with an earlier one still alive
  (the only alias a snapshot of rings on a card can have).
- The pool poisons a matrix only once its host-to-device copy event has
  completed (a fake event stands in for CUDA's).
"""

import importlib.util
import inspect
import json
import os
import textwrap
import types

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.native.decoder import PackedBufferPool as JPackedBufferPool
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu.runtime.sanitizer import BufferSanitizer as JBufferSanitizer
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.native.decoder import PackedBufferPool
from data_accelerator_tpu_torch.runtime import processor as processor_mod
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.runtime.sanitizer import (
    MIN_RUN,
    SENTINEL,
    BufferSanitizer,
)

torch.set_num_threads(2)

RACE_DIR = os.path.join(os.path.dirname(__file__), "data", "race")
BASE_MS = 1_700_000_000_000
SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False,
     "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {}},
]})
PACKAGES = {
    "jax": (JBufferSanitizer, JPackedBufferPool, JFlowProcessor,
            JSettingDictionary),
    "torch": (BufferSanitizer, PackedBufferPool, FlowProcessor,
              SettingDictionary),
}


def _proc(pkg, transform, outputs, capacity=16, extra=None):
    _san, _pool, proc_cls, conf_cls = PACKAGES[pkg]
    conf = {
        "datax.job.name": "SanE2E",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": transform,
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.batchcapacity": str(capacity),
        "datax.job.process.debug.buffersanitizer": "true",
    }
    conf.update(extra or {})
    kwargs = {"device": "cpu"} if pkg == "torch" else {}
    return proc_cls(conf_cls(conf), output_datasets=outputs, **kwargs)


# ---------------------------------------------------------------------------
# unit cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sentinel_scan_thresholds(pkg):
    san = PACKAGES[pkg][0]()
    ok = np.arange(64, dtype=np.int32)
    ok[10] = int(SENTINEL)  # an isolated honest collision
    assert san.scan_table("t", types.SimpleNamespace(cols={"c": ok}, valid=None)) == 0
    bad = np.arange(64, dtype=np.int32)
    bad[8:8 + MIN_RUN] = int(SENTINEL)
    assert san.scan_table("t", types.SimpleNamespace(cols={"c": bad}, valid=None)) == 1
    d = san.drain_metric_deltas()
    assert d == {"Sanitizer_PoisonHit_Count": 1.0,
                 "Sanitizer_GuardedViews_Count": 2.0}
    assert san.drain_metric_deltas() == {}


def test_port_scans_torch_tensors_like_arrays():
    san = BufferSanitizer()
    bad = torch.arange(64, dtype=torch.int32)
    bad[4:4 + MIN_RUN] = int(SENTINEL)
    f32 = torch.zeros(64).view(torch.int32)
    f32[:MIN_RUN] = int(SENTINEL)  # a float column bitcast, as the pool holds it
    t = types.SimpleNamespace(cols={"c": bad, "f": f32.view(torch.float32)},
                              valid=torch.ones(64, dtype=torch.bool))
    assert san.scan_table("t", t) == 2
    assert {e["column"] for e in san.drain_events()} == {"c", "f"}


def _import_fixture(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(RACE_DIR, name + ".py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_snapshotter(pkg, mod):
    """Acquire a pool matrix, 'checkpoint' it through the fixture,
    release (so poison) the matrix, then scan the checkpoint."""
    san_cls, pool_cls = PACKAGES[pkg][:2]
    san = san_cls()
    pool = pool_cls(4, 64)
    pool.sanitizer = san
    mat = pool.acquire()
    mat[:] = 7
    snap = mod.WindowSnapshotter().snapshot(
        mat.numpy() if isinstance(mat, torch.Tensor) else mat
    )
    pool.release(mat)  # poisons the slot
    assert san.poison_count == 1
    table = types.SimpleNamespace(cols={"rows": snap["rows"]}, valid=None)
    return san.scan_table("ckpt", table), san


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_dx800_bad_twin_poison_hits_dynamically(pkg):
    hits, san = _drive_snapshotter(pkg, _import_fixture("dx800_bad"))
    assert hits >= 1
    events = san.drain_events()
    assert events and events[0]["code"] == "DX805"
    assert events[0]["kind"] == "sentinel-run"
    assert events[0]["runLength"] >= MIN_RUN


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_dx800_clean_twin_runs_sanitizer_silent(pkg):
    hits, san = _drive_snapshotter(pkg, _import_fixture("dx800_clean"))
    assert hits == 0
    assert san.poison_hits == 0
    assert san.drain_events() == []


# ---------------------------------------------------------------------------
# the pool poisons only behind a completed copy
# ---------------------------------------------------------------------------
class FakeCopyEvent:
    """Stands in for the CUDA event recorded after a matrix's copy to the
    card: ``query`` is False until the copy is 'done'."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_pool_poisons_only_after_the_copy_event_completes():
    san = BufferSanitizer()
    pool = PackedBufferPool(3, 32)
    pool.sanitizer = san
    mat = pool.acquire()
    mat.fill_(7)
    copied = FakeCopyEvent()
    pool.release(mat, copied)
    # the copy is in flight: the matrix keeps the batch's data, and the
    # pool hands out a fresh matrix instead of it
    assert san.poison_count == 0
    assert bool((mat == 7).all())
    other = pool.acquire()
    assert other is not mat
    assert san.poison_count == 0 and bool((mat == 7).all())
    pool.release(other)  # no copy: poisoned at once; mat still waits
    assert san.poison_count == 1 and bool((mat == 7).all())
    # the copy completes: the next touch poisons it before any reuse
    copied.done = True
    again = pool.acquire()
    assert san.poison_count == 2
    assert bool((mat == int(SENTINEL)).all())
    assert again is mat or again is other
    assert pool.reuse_count == 1


def test_unarmed_pool_never_poisons():
    pool = PackedBufferPool(2, 16)
    mat = pool.acquire()
    mat.fill_(3)
    pool.release(mat)
    assert pool.acquire() is mat and bool((mat == 3).all())


# ---------------------------------------------------------------------------
# armed processors
# ---------------------------------------------------------------------------
OUT_Q = (
    "--DataXQuery--\n"
    "Out = SELECT deviceId, temperature FROM DataXProcessedInput\n"
)


def _rows(i, n=4):
    return [
        {"deviceId": d, "temperature": 1.0 * d,
         "eventTimeStamp": BASE_MS + i * 1000}
        for d in range(n)
    ]


def _lines(rows):
    return b"".join(json.dumps(r).encode() + b"\n" for r in rows)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_armed_processor_runs_sanitizer_silent(pkg):
    """An armed FlowProcessor processes batches (row-encoded and pooled
    JSON bytes) with zero poison hits and exports the guarded-views
    metric, in both packages."""
    proc = _proc(pkg, OUT_Q, ["Out"])
    assert proc.buffer_sanitizer is not None
    seen_guarded = 0.0
    for i in range(3):
        t = BASE_MS + i * 1000
        for raw in (proc.encode_rows(_rows(i), t),
                    proc.encode_json_bytes(_lines(_rows(i)), t)):
            datasets, metrics = proc.process_batch(raw, t)
            assert len(datasets["Out"]) == 4
            assert "Sanitizer_PoisonHit_Count" not in metrics
            seen_guarded += metrics.get("Sanitizer_GuardedViews_Count", 0.0)
    assert seen_guarded > 0
    assert proc.buffer_sanitizer.poison_hits == 0
    assert proc.buffer_sanitizer.poison_count >= 1
    assert proc.buffer_sanitizer.drain_events() == []


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_unarmed_processor_has_no_sanitizer(pkg):
    proc = _proc(pkg, OUT_Q, ["Out"],
                 extra={"datax.job.process.debug.buffersanitizer": "false"})
    assert proc.buffer_sanitizer is None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_seeded_use_after_release_is_dx805(pkg):
    """User code keeps a column view of the pooled ingest matrix past the
    batch: once the batch lands the matrix is released and poisoned, and
    the kept view reads sentinels."""
    proc = _proc(pkg, OUT_Q, ["Out"], capacity=64)
    san = proc.buffer_sanitizer
    raw = proc.encode_json_bytes(_lines(_rows(0, n=32)), BASE_MS)
    _pool, mat = raw.ingest_slot if pkg == "torch" else raw._ingest_pool
    kept = mat[1]  # the temperature row (deviceId, temperature, ...)
    before = np.array(kept, copy=True)
    datasets, metrics = proc.process_batch(raw, BASE_MS)
    assert len(datasets["Out"]) == 32
    assert "Sanitizer_PoisonHit_Count" not in metrics
    assert not np.array_equal(np.asarray(kept), before)  # poisoned under it
    hits = san.scan_table("kept", types.SimpleNamespace(cols={"temperature": kept},
                                                        valid=None))
    assert hits == 1
    (ev,) = san.drain_events()
    assert ev["code"] == "DX805" and ev["kind"] == "sentinel-run"
    assert ev["runLength"] == 64
    assert san.drain_metric_deltas()["Sanitizer_PoisonHit_Count"] == 1.0


WIN_Q = (
    "--DataXQuery--\n"
    "WinAgg = SELECT deviceId, COUNT(*) AS Cnt "
    "FROM DataXProcessedInput_10seconds GROUP BY deviceId\n"
)
WIN_CONF = {
    "datax.job.process.timewindow.DataXProcessedInput_10seconds"
    ".windowduration": "10 seconds",
}


def _seeded_copy_out():
    """The port's ``_copy_out`` with its CPU clone dropped: the regression
    the alias check exists for, seeded from the shipped source."""
    src = textwrap.dedent(inspect.getsource(processor_mod.FlowProcessor._copy_out))
    bad = src.replace("return a.clone()", "return a").replace("@staticmethod\n", "")
    assert bad != src, "seed target moved: update the regression test"
    ns = {"torch": torch, "Optional": None}
    exec(compile(bad, "<seed>", "exec"), ns)  # noqa: S102 — seeded from this repo
    return staticmethod(ns["_copy_out"])


def test_seeded_aliasing_snapshot_trips_check_snapshot(monkeypatch):
    proc = _proc("torch", WIN_Q, ["WinAgg"], extra=WIN_CONF)
    proc.process_batch(proc.encode_rows(_rows(0, n=1), BASE_MS), BASE_MS)
    san = proc.buffer_sanitizer
    good = proc.snapshot_window_state()
    assert san.check_snapshot(good, proc.window_buffers) == 0
    del good
    monkeypatch.setattr(FlowProcessor, "_copy_out", _seeded_copy_out())
    bad = proc.snapshot_window_state()
    hits = san.check_snapshot(bad, proc.window_buffers)
    assert hits >= 1, "sanitizer missed the seeded aliasing snapshot"
    events = san.drain_events()
    assert any(e["kind"] == "snapshot-alias" for e in events)
    assert all(e["code"] == "DX805" for e in events)


def test_jax_sanitizer_convicts_the_same_alias():
    """The reference's check on the reference's rings: a snapshot holding
    the live ring arrays is an alias."""
    proc = _proc("jax", WIN_Q, ["WinAgg"], extra=WIN_CONF)
    proc.process_batch(proc.encode_rows(_rows(0, n=1), BASE_MS), BASE_MS)
    san = proc.buffer_sanitizer
    snap = proc.snapshot_window_state()
    assert san.check_snapshot(snap, proc.window_buffers) == 0
    live = {
        t: {"cols": {c: np.asarray(a) for c, a in buf.cols.items()},
            "valid": np.asarray(buf.valid)}
        for t, buf in proc.window_buffers.items()
    }
    assert san.check_snapshot({"rings": live}, proc.window_buffers) >= 1


def test_snapshot_sharing_an_earlier_live_snapshot_is_an_alias():
    """Rings on a card have no host memory to share; a snapshot there can
    alias only another snapshot still alive (staging buffers reused)."""
    san = BufferSanitizer()
    ring = {"T": types.SimpleNamespace(cols={"c": None}, valid=None)}
    first = {"rings": {"T": {"cols": {"c": np.zeros(8, np.int32)},
                             "valid": np.ones(8, bool)}}}
    assert san.check_snapshot(first, ring) == 0
    # the next checkpoint reuses the first one's staging buffer
    reused = {"rings": {"T": {"cols": {"c": first["rings"]["T"]["cols"]["c"]},
                              "valid": np.ones(8, bool)}}}
    assert san.check_snapshot(reused, ring) == 1
    # a snapshot whose predecessor is gone may reuse its memory
    del first, reused
    fresh = {"rings": {"T": {"cols": {"c": np.zeros(8, np.int32)},
                             "valid": np.ones(8, bool)}}}
    assert san.check_snapshot(fresh, ring) == 0
