"""Partitioned state in the PyTorch port, the mirror of
``test_statepartition.py`` on ``data_accelerator_tpu_torch`` with
``device="cpu"``: hashing/ownership math, the per-partition A/B
snapshot stores, corrupt-snapshot fallback (DX530/531), the object-store
client's retries and the fail-closed state store, window snapshot
split/merge, the ingest ownership filter, and partition ids equal to the
JAX package's for every key kind.

Not mirrored, with their modules: the compile cache's fail-open posture
(the JAX compile cache, ``compile/aotcache.py``, has no counterpart in
eager PyTorch) and the rescale partition-map wiring through
``JobOperation`` (the control plane, ``serve/jobs.py``).
"""

import functools
import json
import os
import random

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.schema import StringDictionary as JStringDictionary
from data_accelerator_tpu.runtime import statepartition as jstatepartition
from data_accelerator_tpu_torch.runtime import statetable as _statetable

from data_accelerator_tpu_torch.runtime.statepartition import (
    LocalSnapshotStore,
    ObjstoreSnapshotStore,
    SnapshotStoreError,
    merge_window_snapshots,
    owned_partitions,
    partition_ids,
    partition_map,
    partition_of,
    reassigned_partitions,
    snapshot_from_bytes,
    snapshot_to_bytes,
    split_window_snapshot,
)

# the tests ask for the CPU; the port's state tables default to the card
StateTable = functools.partial(_statetable.StateTable, device="cpu")


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------
def test_partition_ids_deterministic_and_in_range():
    vals = np.arange(10_000)
    p1 = partition_ids(vals, 16)
    p2 = partition_ids(vals, 16)
    assert (p1 == p2).all()
    assert p1.min() >= 0 and p1.max() < 16


def test_partition_ids_spread_is_reasonable():
    counts = np.bincount(partition_ids(np.arange(16_000), 16), minlength=16)
    # a mixed hash over 16k sequential keys should not starve or
    # overload any partition by more than ~2x
    assert counts.min() > 500 and counts.max() < 2000, counts


def test_partition_ids_string_kind_hashes_decoded_value():
    class Dict_:
        def decode(self, i):
            return {1: "alpha", 2: "beta"}.get(i)

    ids = np.array([1, 2, 1, 2])
    p = partition_ids(ids, 8, kind="string", dictionary=Dict_())
    assert p[0] == p[2] and p[1] == p[3]
    # matches hashing the decoded string directly (id-independent)
    assert p[0] == partition_of("alpha", 8, kind="string")
    assert p[1] == partition_of("beta", 8, kind="string")


def test_partition_ids_float_and_bool_kinds():
    pf = partition_ids(np.array([1.5, 2.5, 1.5], np.float32), 8,
                       kind="double")
    assert pf[0] == pf[2]
    pb = partition_ids(np.array([True, False, True]), 8, kind="boolean")
    assert pb[0] == pb[2]


# ---------------------------------------------------------------------------
# Ownership
# ---------------------------------------------------------------------------
def test_owned_partitions_contiguous_and_complete():
    for n in (1, 2, 3, 5, 16):
        all_owned = []
        for i in range(1, n + 1):
            owned = owned_partitions(i, n, 16)
            assert owned == list(range(owned[0], owned[-1] + 1))  # contiguous
            all_owned += owned
        assert sorted(all_owned) == list(range(16))  # exactly once


def test_owned_partitions_ranges_move_only_at_edges():
    # scale 2 -> 3: replica 1's range shrinks at its right edge only
    before = owned_partitions(1, 2, 16)
    after = owned_partitions(1, 3, 16)
    assert after == before[: len(after)]


def test_owned_partitions_validates():
    with pytest.raises(ValueError):
        owned_partitions(0, 2, 16)
    with pytest.raises(ValueError):
        owned_partitions(3, 2, 16)
    with pytest.raises(ValueError):
        owned_partitions(1, 1, 0)


def test_partition_map_and_reassignment():
    m1 = partition_map(1, 16)
    m2 = partition_map(2, 16)
    assert sorted(sum(m2.values(), [])) == list(range(16))
    moved = reassigned_partitions(m1, m2)
    # scale 1 -> 2 hands replica 2's whole range off
    assert moved == m2[2]
    # JSON round trip (string keys) is equivalent
    m1j = {str(k): v for k, v in m1.items()}
    assert reassigned_partitions(m1j, m2) == moved
    assert reassigned_partitions(m2, m2) == []


# ---------------------------------------------------------------------------
# Snapshot stores
# ---------------------------------------------------------------------------
def test_local_store_roundtrip_and_pointer(tmp_path):
    store = LocalSnapshotStore(str(tmp_path))
    store.put_files("p00", "A", {"table.npz": b"abc", "meta.json": b"{}"})
    assert store.get_pointer("p00") is None
    store.put_pointer("p00", "A")
    assert store.get_pointer("p00") == "A"
    assert store.get_file("p00", "A", "table.npz") == b"abc"
    assert store.get_file("p00", "B", "table.npz") is None


def test_local_store_writes_are_durable(tmp_path, monkeypatch):
    """Satellite: snapshot files AND the pointer commit go through
    tmp-write + fsync + _durable_replace — the power-loss contract the
    checkpointers already had."""
    synced = []
    real_fsync = os.fsync

    def spy(fd):
        try:
            synced.append(os.readlink(f"/proc/self/fd/{fd}"))
        except OSError:
            synced.append("<unknown>")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy)
    store = LocalSnapshotStore(str(tmp_path / "st"))
    store.put_files("p03", "B", {"table.npz": b"xyz"})
    store.put_pointer("p03", "B")
    # the data file and the pointer were both fsynced while still .tmp,
    # and their directories after the rename
    assert any(p.endswith("table.npz.tmp") for p in synced), synced
    assert any(p.endswith("pointer.tmp") for p in synced), synced
    assert any(p.rstrip("/").endswith("p03/B") for p in synced), synced
    assert any(p.rstrip("/").endswith("p03") for p in synced), synced


class _FlakyStore:
    """In-memory object-store stub whose transport fails the first N
    calls (5xx), then recovers — the retry-posture test double."""

    def __init__(self, fail_first: int = 0, always_fail: bool = False):
        self.mem = {}
        self.calls = 0
        self.fail_first = fail_first
        self.always_fail = always_fail

    def transport(self, method, url, body):
        self.calls += 1
        if self.always_fail or self.calls <= self.fail_first:
            return 503, b"unavailable"
        from urllib.parse import unquote, urlparse

        path = urlparse(url).path.lstrip("/")
        bucket, _, key = path.partition("/")
        key = unquote(key)
        if method == "PUT":
            self.mem[key] = body
            return 201, b""
        if method == "GET" and key:
            data = self.mem.get(key)
            return (200, data) if data is not None else (404, b"")
        if method == "GET":
            q = urlparse(url).query
            prefix = unquote(q.split("prefix=", 1)[1]) if "prefix=" in q \
                else ""
            keys = sorted(k for k in self.mem if k.startswith(prefix))
            return 200, json.dumps(keys).encode()
        if method == "DELETE":
            return (204, b"") if self.mem.pop(key, None) is not None \
                else (404, b"")
        return 400, b""


def _objstore(flaky: _FlakyStore, retries: int = 3):
    from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreClient

    return ObjectStoreClient(
        "http://store.test:1", "b", http=flaky.transport, retries=retries
    )


def test_client_retries_transient_5xx_with_backoff(monkeypatch):
    import data_accelerator_tpu_torch.serve.objectstore as om

    delays = []
    monkeypatch.setattr(om.time, "sleep", lambda s: delays.append(s))
    # the jitter from a seeded sequence: unseeded, the second delay falls
    # under 0.8 x the first in about 1.25% of runs (a second jitter under
    # 0.4 x the first), whatever the code does
    jitter = random.Random(11)
    monkeypatch.setattr(om.random, "random", jitter.random)
    expected = random.Random(11)
    flaky = _FlakyStore(fail_first=2)
    client = _objstore(flaky)
    client.put("k", b"v")  # 2 failures + 1 success within 3 attempts
    assert flaky.calls == 3
    assert len(delays) == 2
    assert delays == [
        pytest.approx(om.RETRY_BASE_S * 2 ** a * (0.5 + expected.random()))
        for a in range(2)
    ]
    assert delays[1] > delays[0] * 0.8  # roughly doubling, jittered


def test_client_gives_up_after_bounded_attempts(monkeypatch):
    import data_accelerator_tpu_torch.serve.objectstore as om

    monkeypatch.setattr(om.time, "sleep", lambda s: None)
    flaky = _FlakyStore(always_fail=True)
    client = _objstore(flaky)
    with pytest.raises(IOError):
        client.get("k")
    assert flaky.calls == 3  # bounded: exactly `retries` attempts


def test_client_does_not_retry_definitive_answers():
    flaky = _FlakyStore()
    client = _objstore(flaky)
    assert client.get("absent") is None  # 404: one call, no retry
    assert flaky.calls == 1


def test_state_store_fails_closed_on_dead_store(monkeypatch):
    """Satellite posture #2: the state-snapshot store RAISES after the
    bounded retries — the batch requeues rather than committing state
    that never landed."""
    import data_accelerator_tpu_torch.serve.objectstore as om

    monkeypatch.setattr(om.time, "sleep", lambda s: None)
    store = ObjstoreSnapshotStore("objstore://dead.test:1/b/p")
    store._client = _objstore(_FlakyStore(always_fail=True))
    with pytest.raises(SnapshotStoreError):
        store.put_files("seen/p00", "A", {"table.npz": b"x"})
    with pytest.raises(SnapshotStoreError):
        store.get_pointer("seen/p00")


def test_state_store_retries_then_succeeds(monkeypatch):
    import data_accelerator_tpu_torch.serve.objectstore as om

    monkeypatch.setattr(om.time, "sleep", lambda s: None)
    store = ObjstoreSnapshotStore("objstore://flaky.test:1/b/p")
    flaky = _FlakyStore(fail_first=2)
    store._client = _objstore(flaky)
    store.put_pointer("seen/p00", "A")  # 2 transient failures absorbed
    flaky.fail_first = 0
    assert store.get_pointer("seen/p00") == "A"


# ---------------------------------------------------------------------------
# StateTable: partitioned A/B + fallback
# ---------------------------------------------------------------------------
def _schema():
    from data_accelerator_tpu_torch.compile.planner import ViewSchema

    return ViewSchema({"k": "long", "v": "double"})


def _table(rows):
    from data_accelerator_tpu_torch.compile.planner import TableData

    cap = 32
    k = np.zeros(cap, np.int32)
    v = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    for i, (kk, vv) in enumerate(rows):
        k[i], v[i], valid[i] = kk, vv, True
    return TableData(
        {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
        torch.from_numpy(valid),
    )


def _as_map(t):
    return {
        int(k): float(v) for k, v, ok in zip(
            np.asarray(t.cols["k"]), np.asarray(t.cols["v"]),
            np.asarray(t.valid),
        ) if ok
    }


def test_statetable_partitioned_roundtrip(tmp_path):
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    d = StringDictionary()
    st = StateTable("acc", _schema(), 32, str(tmp_path), partitions=8)
    rows = [(i, float(i * 10)) for i in range(12)]
    st.overwrite(_table(rows), d)
    st.persist()
    st2 = StateTable("acc", _schema(), 32, str(tmp_path), partitions=8)
    assert _as_map(st2.load(StringDictionary())) == dict(rows)
    # the on-disk layout is per-partition A/B + pointer
    pdirs = sorted(p for p in os.listdir(tmp_path) if p.startswith("p"))
    assert len(pdirs) == 8
    assert os.path.exists(tmp_path / "p00" / "pointer")


def test_statetable_owned_subset_loads_only_owned_keys(tmp_path):
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    d = StringDictionary()
    full = StateTable("acc", _schema(), 32, str(tmp_path), partitions=8)
    rows = [(i, float(i)) for i in range(16)]
    full.overwrite(_table(rows), d)
    full.persist()
    loaded = {}
    for idx in (1, 2):
        part = StateTable(
            "acc", _schema(), 32, str(tmp_path), partitions=8,
            owned=owned_partitions(idx, 2, 8),
        )
        m = _as_map(part.load(StringDictionary()))
        for k in m:
            # each key belongs to exactly one replica's range
            assert k not in loaded
        loaded.update(m)
    assert loaded == dict(rows)


def test_statetable_corrupt_active_falls_back_to_standby(tmp_path):
    """Satellite: a corrupt/truncated active snapshot no longer kills
    the host — the loader falls back to the standby side, counts
    State_LoadFallback_Count, and queues a DX530 event."""
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    d = StringDictionary()
    stats, events = {}, []
    st = StateTable("acc", _schema(), 32, str(tmp_path), partitions=4)
    st.overwrite(_table([(1, 1.0)]), d)
    st.persist()  # commit 1: every partition side B
    st.overwrite(_table([(1, 2.0)]), d)
    st.persist()  # commit 2: side A active, B standby (holds v=1.0)
    p = partition_of(1, 4)
    active = LocalSnapshotStore(str(tmp_path)).get_pointer(f"p{p:02d}")
    path = tmp_path / f"p{p:02d}" / active / "table.npz"
    path.write_bytes(path.read_bytes()[:10])  # torn write
    st2 = StateTable("acc", _schema(), 32, str(tmp_path), partitions=4,
                     stats=stats, events=events)
    m = _as_map(st2.load(StringDictionary()))
    assert m == {1: 1.0}  # the standby commit
    assert stats["LoadFallback_Count"] >= 1
    assert any(e["code"] == "DX530" for e in events)


def test_statetable_both_sides_bad_loads_empty_with_dx531(tmp_path):
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    d = StringDictionary()
    stats, events = {}, []
    st = StateTable("acc", _schema(), 32, str(tmp_path), partitions=4)
    st.overwrite(_table([(1, 1.0)]), d)
    st.persist()
    st.overwrite(_table([(1, 2.0)]), d)
    st.persist()
    p = partition_of(1, 4)
    for side in ("A", "B"):
        f = tmp_path / f"p{p:02d}" / side / "table.npz"
        if f.exists():
            f.write_bytes(b"\x00garbage")
    st2 = StateTable("acc", _schema(), 32, str(tmp_path), partitions=4,
                     stats=stats, events=events)
    assert _as_map(st2.load(StringDictionary())) == {}
    assert any(e["code"] == "DX531" for e in events)


def test_statetable_absent_active_never_loads_uncommitted_standby(tmp_path):
    """A crash between overwrite() (standby written, in-memory flip)
    and persist() (pointer never committed) leaves a fresh partition
    with pointer=None -> default active 'A' and side A absent. The
    loader must load EMPTY — falling through to side B would apply the
    UNCOMMITTED batch, and the replayed un-acked window on top of it
    double-counts non-idempotent accumulators."""
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    d = StringDictionary()
    st = StateTable("acc", _schema(), 32, str(tmp_path), partitions=4)
    st.overwrite(_table([(1, 1.0)]), d)  # standby (B) written, no commit
    p = partition_of(1, 4)
    assert LocalSnapshotStore(str(tmp_path)).get_pointer(f"p{p:02d}") is None
    assert (tmp_path / f"p{p:02d}" / "B" / "table.npz").exists()
    stats, events = {}, []
    st2 = StateTable("acc", _schema(), 32, str(tmp_path), partitions=4,
                     stats=stats, events=events)
    assert _as_map(st2.load(StringDictionary())) == {}
    assert "LoadFallback_Count" not in stats  # absent != corrupt


def test_statetable_string_partition_key_and_remap(tmp_path):
    """String keys hash by decoded value and remap through meta.json
    into a fresh process's dictionary."""
    from data_accelerator_tpu_torch.compile.planner import TableData, ViewSchema
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    schema = ViewSchema({"name": "string", "v": "double"})
    d1 = StringDictionary()
    ids = [d1.encode(s) for s in ("alice", "bob", "carol")]
    cap = 8
    name = np.zeros(cap, np.int32)
    v = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    for i, sid in enumerate(ids):
        name[i], v[i], valid[i] = sid, float(i), True
    t = TableData({"name": torch.from_numpy(name), "v": torch.from_numpy(v)},
                  torch.from_numpy(valid))
    st = StateTable("s", schema, cap, str(tmp_path), partitions=4)
    st.overwrite(t, d1)
    st.persist()
    d2 = StringDictionary()
    d2.encode("unrelated")  # ids shifted in the new process
    st2 = StateTable("s", schema, cap, str(tmp_path), partitions=4)
    loaded = st2.load(d2)
    got = {
        d2.decode(int(n)): float(x) for n, x, ok in zip(
            np.asarray(loaded.cols["name"]), np.asarray(loaded.cols["v"]),
            np.asarray(loaded.valid),
        ) if ok
    }
    assert got == {"alice": 0.0, "bob": 1.0, "carol": 2.0}


def test_statetable_mirror_push_and_successor_pull(tmp_path):
    """The handoff path: a predecessor persists through the objstore
    mirror; a successor with a FRESH local dir pulls exactly its owned
    partitions."""
    from data_accelerator_tpu_torch.core.schema import StringDictionary
    from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreServer

    server = ObjectStoreServer(port=0).start()
    try:
        url = f"objstore://127.0.0.1:{server.port}/b/flow1"
        d = StringDictionary()
        stats = {}
        pred = StateTable(
            "acc", _schema(), 32, str(tmp_path / "pred"), partitions=8,
            mirror=ObjstoreSnapshotStore(url), stats=stats,
        )
        rows = [(i, float(i)) for i in range(16)]
        pred.overwrite(_table(rows), d)
        pred.persist()
        assert stats["Snapshot_Push_Count"] >= 1
        succ_stats = {}
        succ = StateTable(
            "acc", _schema(), 32, str(tmp_path / "succ"), partitions=8,
            owned=owned_partitions(2, 2, 8),
            mirror=ObjstoreSnapshotStore(url), stats=succ_stats,
        )
        m = _as_map(succ.load(StringDictionary()))
        assert m  # its half of the key space
        assert succ_stats["Snapshot_Pull_Count"] >= 1
        expect = {
            k: v for k, v in rows
            if partition_of(k, 8) in owned_partitions(2, 2, 8)
        }
        assert m == expect
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Window snapshot split / merge
# ---------------------------------------------------------------------------
def _win_snap(base_ms=1_000_000, counter=3):
    k = np.arange(24).reshape(3, 8).astype(np.int32)
    return {
        "rings": {"T": {
            "cols": {"k": k, "ts": np.zeros((3, 8), np.int32)},
            "valid": np.ones((3, 8), bool),
        }},
        "slot_counter": counter,
        "base_ms": base_ms,
        "dictionary": None,
    }


class _IdentityDict:
    def encode(self, s):
        return 1


def test_window_split_covers_every_row_exactly_once():
    snap = _win_snap()
    parts = split_window_snapshot(snap, 8, {"T": ("k", "long")})
    total = sum(
        int(p["rings"]["T"]["valid"].sum()) for p in parts.values()
    )
    assert total == 24


def test_window_split_compacts_to_member_rows():
    """A partition snapshot ships only its member rows (re-packed per
    slot, width truncated to the widest slot) plus the original ring
    capacity as ``cap`` — not P masked copies of the entire ring."""
    snap = _win_snap()
    parts = split_window_snapshot(snap, 8, {"T": ("k", "long")})
    for part in parts.values():
        ring = part["rings"]["T"]
        assert ring["cap"] == 8
        widest = int(ring["valid"].sum(axis=1).max())
        assert ring["valid"].shape == (3, widest)
        for a in ring["cols"].values():
            assert a.shape == ring["valid"].shape
    # ...and the shipped cell count is bounded by slots x member rows
    # (worst case: every member alone in its slot), not P x ring size
    total_cells = sum(
        p["rings"]["T"]["valid"].size for p in parts.values()
    )
    assert total_cells <= 3 * 24  # vs 8 partitions x 24 uncompacted


def test_window_split_merge_roundtrip_repacks_rows():
    snap = _win_snap()
    parts = split_window_snapshot(snap, 8, {"T": ("k", "long")})
    rt = [snapshot_from_bytes(snapshot_to_bytes(p)) for p in parts.values()]
    merged = merge_window_snapshots(
        rt, {"T": {"k": "long", "ts": "timestamp"}}, _IdentityDict(), "ts"
    )
    ring = merged["rings"]["T"]
    got = sorted(ring["cols"]["k"][ring["valid"]].tolist())
    assert got == list(range(24))
    assert merged["slot_counter"] == 3
    assert merged["base_ms"] == 1_000_000
    assert merged["dictionary"] is None


def test_window_merge_rebases_timestamps_across_bases():
    s1 = _win_snap(base_ms=10_000)
    s2 = _win_snap(base_ms=4_000)
    s1["rings"]["T"]["valid"][:] = False
    s1["rings"]["T"]["valid"][0, :2] = True
    s1["rings"]["T"]["cols"]["ts"][0, :2] = 500
    s2["rings"]["T"]["valid"][:] = False
    s2["rings"]["T"]["valid"][0, :2] = True
    s2["rings"]["T"]["cols"]["ts"][0, :2] = 500
    merged = merge_window_snapshots(
        [s1, s2], {"T": {"k": "long", "ts": "timestamp"}},
        _IdentityDict(), "ts",
    )
    assert merged["base_ms"] == 10_000  # newest predecessor wins
    ring = merged["rings"]["T"]
    ts = sorted(ring["cols"]["ts"][ring["valid"]].tolist())
    # s1 rows keep rel 500; s2 rows shift by (4000 - 10000) = -6000
    assert ts == [-5500, -5500, 500, 500]


def test_window_merge_overflow_drops_and_counts():
    s1, s2 = _win_snap(), _win_snap()  # 8 valid rows per slot each
    merged = merge_window_snapshots(
        [s1, s2], {"T": {"k": "long", "ts": "timestamp"}},
        _IdentityDict(), "ts",
    )
    assert merged["dropped_rows"] == 24  # capacity 8/slot, 16 offered
    assert int(merged["rings"]["T"]["valid"].sum()) == 24


def test_unkeyed_table_lands_in_partition_zero():
    snap = _win_snap()
    parts = split_window_snapshot(snap, 4, {})  # no key columns known
    assert int(parts[0]["rings"]["T"]["valid"].sum()) == 24
    assert all(
        int(parts[p]["rings"]["T"]["valid"].sum()) == 0 for p in (1, 2, 3)
    )


# ---------------------------------------------------------------------------
# Ingest ownership filter
# ---------------------------------------------------------------------------
def _stateful_proc(tmp_path, replica_index, replica_count):
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

    t = tmp_path / "f.transform"
    if not t.exists():
        t.write_text(
            "--DataXQuery--\n"
            "Out = SELECT k, v FROM DataXProcessedInput\n"
        )
    schema = json.dumps({"type": "struct", "fields": [
        {"name": "k", "type": "long", "nullable": False, "metadata": {}},
        {"name": "v", "type": "double", "nullable": False, "metadata": {}},
    ]})
    return FlowProcessor(
        SettingDictionary({
            "datax.job.name": "FilterTest",
            "datax.job.input.default.blobschemafile": schema,
            "datax.job.process.transform": str(t),
            "datax.job.process.batchcapacity": "16",
            "datax.job.process.state.partitions": "8",
            "datax.job.process.state.partitionkey": "k",
            "datax.job.process.state.replicaindex": str(replica_index),
            "datax.job.process.state.replicacount": str(replica_count),
            "datax.job.process.state.filteringest": "true",
        }),
        output_datasets=["Out"],
        device="cpu",
    )


def test_ingest_filter_splits_stream_exactly_once_across_group(tmp_path):
    """Two replicas fed the SAME rows process disjoint, complete key
    subsets — the consumer-group contract over key-range partitions."""
    rows = [{"k": i % 8, "v": float(i)} for i in range(16)]
    seen = []
    for idx in (1, 2):
        proc = _stateful_proc(tmp_path, idx, 2)
        raw = proc.encode_rows(rows, 0)
        valid = np.asarray(raw.valid)
        ks = [rows[i]["k"] for i in range(len(rows)) if valid[i]]
        assert proc.state_stats.get("IngestFiltered_Count", 0) > 0
        seen += ks
    assert sorted(set(seen)) == sorted(set(r["k"] for r in rows))
    assert len(seen) == len(rows)  # nothing dropped, nothing doubled


def test_ingest_filter_off_for_single_replica(tmp_path):
    proc = _stateful_proc(tmp_path, 1, 1)
    assert not proc.state_filter_ingest
    raw = proc.encode_rows([{"k": 3, "v": 1.0}], 0)
    assert int(np.asarray(raw.valid).sum()) == 1


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------
def _keys(kind, rs, n):
    if kind == "long":
        return rs.randint(-2**31, 2**31 - 1, size=n).astype(np.int32)
    if kind == "double":
        return rs.uniform(-1e6, 1e6, size=n).astype(np.float32)
    if kind == "boolean":
        return rs.rand(n) < 0.5
    return np.array([f"key-{i}" for i in rs.randint(0, 50, size=n)])


@pytest.mark.parametrize("kind", ["long", "double", "boolean", "string"])
@pytest.mark.parametrize("partitions", [1, 4, 16])
def test_partition_ids_equal_the_jax_package(kind, partitions):
    """The same keys of each kind land in the same partition in both
    packages; string keys hash their decoded value, so each package's
    own dictionary (ids in a different order) gives the same ids."""
    from data_accelerator_tpu_torch.core.schema import StringDictionary

    keys = _keys(kind, np.random.RandomState(partitions), 512)
    if kind == "string":
        jd, td = JStringDictionary(), StringDictionary()
        td.encode("taken-first")  # the port's ids shifted by one
        jvals = np.array([jd.encode(s) for s in keys], np.int32)
        tvals = np.array([td.encode(s) for s in keys], np.int32)
        want = jstatepartition.partition_ids(jvals, partitions, kind, dictionary=jd)
        got = partition_ids(tvals, partitions, kind, dictionary=td)
        assert all(
            partition_of(s, partitions, kind) == p for s, p in zip(keys, got)
        )
    else:
        want = jstatepartition.partition_ids(keys, partitions, kind)
        got = partition_ids(keys, partitions, kind)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)


def _filter_procs(tmp_path, replica_index):
    """The same filtered flow on both packages for one replica of two."""
    from data_accelerator_tpu.core.config import SettingDictionary as JSD
    from data_accelerator_tpu.runtime.processor import FlowProcessor as JFP

    tproc = _stateful_proc(tmp_path, replica_index, 2)
    jproc = JFP(JSD(dict(tproc.dict.dict)), output_datasets=["Out"])
    return jproc, tproc


@pytest.mark.parametrize("path", ["rows", "columns", "json-packed", "json-rows"])
def test_ingest_filter_equals_the_jax_package_on_every_encode_path(tmp_path, path):
    """Each encode path of the port drops exactly the rows the JAX
    package's drops, counted the same, and the step's output keeps the
    owned rows only."""
    rs = np.random.RandomState(11)
    ks = rs.randint(0, 64, size=12)
    vs = rs.uniform(0, 10, size=12).astype(np.float32)
    rows = [{"k": int(k), "v": float(v)} for k, v in zip(ks, vs)]
    blob = b"".join(json.dumps(r).encode() + b"\n" for r in rows)
    for idx in (1, 2):
        jproc, tproc = _filter_procs(tmp_path, idx)
        masks, outs = [], []
        for proc in (jproc, tproc):
            if path == "rows":
                raw = proc.encode_rows(rows, 0)
            elif path == "columns":
                raw = proc.encode_columns(
                    {"k": ks.astype(np.int32), "v": vs}, len(rows))
            else:
                raw = proc.encode_json_bytes(
                    blob, 0, packed=path == "json-packed")
            if hasattr(raw, "valid"):
                masks.append(np.asarray(raw.valid)[: len(rows)].astype(bool))
            else:  # a packed matrix: validity is its last row
                masks.append(np.asarray(raw.data)[-1][: len(rows)] != 0)
            ds, m = proc.process_batch(raw, 1000)
            outs.append((ds["Out"], m.get("State_IngestFiltered_Count")))
        assert np.array_equal(masks[0], masks[1])
        assert outs[0] == outs[1]
        owned = set(owned_partitions(idx, 2, 8))
        want = [r for r in rows if partition_of(r["k"], 8) in owned]
        assert [r["k"] for r in outs[1][0]] == [r["k"] for r in want]


def test_state_metric_names_are_the_jax_registrys_but_the_rescale_count():
    """The port registers every State_* name of the JAX package's
    registry except State_Partition_Reassigned_Count, which only the
    control plane's rescale emits."""
    import re

    from data_accelerator_tpu.constants import MetricName as JMetricName
    from data_accelerator_tpu_torch.constants import MetricName

    patterns = [p for p in JMetricName.RUNTIME_METRIC_PATTERNS if p.startswith("State_")]
    names = MetricName.STATE_METRICS
    assert all(any(re.fullmatch(p, n) for p in patterns) for n in names)
    missing = [p for p in patterns if not any(re.fullmatch(p, n) for n in names)]
    assert missing == ["State_Partition_Reassigned_Count"]
