"""The port's mesh execution (``dist/``) beside the JAX package's: twins of
``tests/test_dist.py``'s five tests at 8 virtual CPU shards
(``make_mesh(8, devices=("cpu",) * 8)``, the counterpart of the JAX
package's 8 virtual CPU devices), on its ``make_conf``/``crafted_raw``
inputs.

The sharded port's ``Hot`` and ``PerDevice`` equal the JAX package's
8-device mesh and the port's single device: ints exactly, floats within
rtol 1e-5. Beside the twins: ``make_mesh`` without a card and above the
visible count, ``process.numchips`` clamped on a CPU processor, and the
step's collective census held to the byte against the logical sizes of
the tables the flow gathers, worked out here from its shapes.
"""

import logging
import types

import jax
import numpy as np
import pytest
import torch

from data_accelerator_tpu.compile.planner import TableData as JTableData
from data_accelerator_tpu.dist import HostIngestPlan as JHostIngestPlan
from data_accelerator_tpu.dist import assigned_partitions as jassigned_partitions
from data_accelerator_tpu.dist import make_mesh as jmake_mesh
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.analysis.costmodel import (
    allgather_wire_bytes,
    allreduce_wire_bytes,
    table_bytes,
)
from data_accelerator_tpu_torch.compile.planner import TableData
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.dist import (
    HostIngestPlan,
    assigned_partitions,
    make_mesh,
    ring_sharding,
    row_sharding,
)
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.runtime.timewindow import ShardedWindowBuffers
from test_dist import crafted_raw, make_conf

OUTPUTS = ["Hot", "PerDevice"]
BASE_MS = 1_700_000_000_000
CPU8 = ("cpu",) * 8


def _conf(tmp_path, **extra):
    d = make_conf(tmp_path)
    return SettingDictionary({**d.dict, **extra})


def _cols(proc):
    """test_dist.crafted_raw over the port's raw schema."""
    return crafted_raw(types.SimpleNamespace(
        batch_capacity=proc.batch_capacity, raw_schema=proc.spec.raw_schema))


def _run(proc, cols, valid, batches=3):
    out = []
    for i in range(batches):
        raw = TableData({k: torch.from_numpy(v) for k, v in cols.items()},
                        torch.from_numpy(valid))
        out.append(proc.process_batch(raw, batch_time_ms=BASE_MS + i * 1000))
    return out


def _jrun(proc, cols, valid, batches=3):
    import jax.numpy as jnp

    out = []
    for i in range(batches):
        raw = JTableData({k: jnp.asarray(v) for k, v in cols.items()},
                         jnp.asarray(valid))
        out.append(proc.process_batch(raw, batch_time_ms=BASE_MS + i * 1000))
    return out


def _same_rows(got, want, keys):
    """Sorted rows equal: ints exactly, floats within rtol 1e-5."""
    g = sorted(tuple(r[k] for k in keys) for r in got)
    w = sorted(tuple(r[k] for k in keys) for r in want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-5)
            else:
                assert x == y


KEYS = {"Hot": ["deviceId", "temperature"], "PerDevice": ["deviceId", "Cnt", "MaxT"]}


def test_sharded_matches_single_device(tmp_path):
    d = _conf(tmp_path)
    single = FlowProcessor(d, batch_capacity=256, output_datasets=OUTPUTS, device="cpu")
    sharded = FlowProcessor(d, batch_capacity=256, output_datasets=OUTPUTS,
                            mesh=make_mesh(8, devices=CPU8))
    jsharded = JFlowProcessor(make_conf(tmp_path), batch_capacity=256,
                              mesh=jmake_mesh(8), output_datasets=OUTPUTS)
    assert sharded.batch_capacity % 8 == 0
    assert sharded.batch_capacity == jsharded.batch_capacity

    cols, valid = _cols(single)
    res_single = _run(single, cols, valid)
    res_sharded = _run(sharded, cols, valid)
    res_jax = _jrun(jsharded, cols, valid)
    for (ds_s, m_s), (ds_m, m_m), (ds_j, m_j) in zip(res_single, res_sharded, res_jax):
        for out, keys in KEYS.items():
            # the gathered tables keep the single device's row order
            assert ds_m[out] == ds_s[out]
            _same_rows(ds_m[out], ds_j[out], keys)
        assert m_s["Input_DataXProcessedInput_Events_Count"] == (
            m_m["Input_DataXProcessedInput_Events_Count"]
        ) == m_j["Input_DataXProcessedInput_Events_Count"]
        assert m_m["Mesh_ICI_Bytes"] > 0 and m_m["Mesh_Reshard_Count"] >= 1


def test_sharded_input_placement(tmp_path):
    """Raw columns pre-placed with the row sharding are consumed as
    they lie; the ring state stays sharded across steps, one shard a
    mesh device."""
    mesh = make_mesh(8, devices=CPU8)
    proc = FlowProcessor(_conf(tmp_path), batch_capacity=256, mesh=mesh,
                         output_datasets=["PerDevice"])
    cols, valid = _cols(proc)
    rows = row_sharding(mesh)
    raw = TableData(
        {k: torch.cat(rows.shard(torch.from_numpy(v))) for k, v in cols.items()},
        torch.cat(rows.shard(torch.from_numpy(valid))),
    )
    for i in range(2):
        proc.process_batch(raw, batch_time_ms=BASE_MS + i * 1000)
    ring = proc.window_buffers["DataXProcessedInput"]
    assert isinstance(ring, ShardedWindowBuffers)
    assert len(ring.shards) == 8 and ring.capacity == 256
    for shard, dev in zip(ring.shards, mesh.devices):
        for a in [*shard.cols.values(), shard.valid]:
            assert a.device == dev and tuple(a.shape) == (ring.slots, 32)
    # shard i holds the ring's capacity range i, as ring_sharding lays it out
    whole = torch.arange(ring.slots * 256).reshape(ring.slots, 256)
    assert [tuple(p[0, :2].tolist()) for p in ring_sharding(mesh).shard(whole)][1] == (32, 33)
    # the JAX package's ring holds the same layout over its 8 devices
    jproc = JFlowProcessor(make_conf(tmp_path), batch_capacity=256, mesh=jmake_mesh(8),
                           output_datasets=["PerDevice"])
    _jrun(jproc, cols, valid, batches=1)
    jring = jproc.window_buffers["DataXProcessedInput"]
    ts = jring.cols[jproc.timestamp_column]
    assert len(ts.sharding.device_set) == len(ring.shards)
    assert tuple(ts.shape) == (ring.slots, ring.capacity)


def test_host_ingest_plan_single_process_owns_everything():
    """On one process the plan covers all partitions and rows; the batch
    assembled from 'local' data is row-sharded over the mesh, as the
    JAX package's."""
    mesh = make_mesh(8, devices=CPU8)
    plan = HostIngestPlan(mesh, global_capacity=64, n_partitions=16, max_rate=32000)
    jplan = JHostIngestPlan(jmake_mesh(8), global_capacity=64, n_partitions=16,
                            max_rate=32000)
    assert plan.partitions == jplan.partitions == list(range(16))
    assert plan.local_capacity == jplan.local_capacity == 64
    assert plan.max_rate == jplan.max_rate == 32000
    assert plan.rows == range(64)

    cols = {"v": np.arange(64, dtype=np.int32)}
    valid = np.ones(64, dtype=bool)
    batch = plan.make_global(cols, valid)
    table = jplan.make_global(cols, valid)
    assert batch.global_rows == table.cols["v"].shape[0] == 64
    assert len(batch.shards) == len(table.cols["v"].sharding.device_set) == 8
    assert [tuple(s.cols["v"].shape) for s in batch.shards] == [(8,)] * 8
    assert batch.local().cols["v"].tolist() == np.asarray(table.cols["v"]).tolist()
    assert batch.all_reduce(torch.tensor(5)).item() == 5  # one host: no group


def test_assigned_partitions_balance():
    p0 = assigned_partitions(10, process_index=0, process_count=4)
    p3 = assigned_partitions(10, process_index=3, process_count=4)
    assert p0 == jassigned_partitions(10, process_index=0, process_count=4) == [0, 4, 8]
    assert p3 == jassigned_partitions(10, process_index=3, process_count=4) == [3, 7]
    allp = sorted(sum((assigned_partitions(10, i, 4) for i in range(4)), []))
    assert allp == list(range(10))


def test_host_ingest_plan_rejects_wrong_shard_size():
    plan = HostIngestPlan(make_mesh(8, devices=CPU8), 64, 4, 1000)
    jplan = JHostIngestPlan(jmake_mesh(8), 64, 4, 1000)
    for p in (plan, jplan):
        with pytest.raises(ValueError):
            p.make_global({"v": np.zeros(32, np.int32)}, np.ones(32, bool))


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    """No card and no ``devices=``: ``make_mesh`` raises rather than
    build CPU shards; above the visible count it raises ``ValueError``,
    as the JAX package's does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    with pytest.raises(ValueError, match="only 8 available"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match=f"only {len(jax.devices())} available"):
        jmake_mesh(len(jax.devices()) + 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="only 2 available"):
        make_mesh(4)


def test_numchips_clamps_on_a_cpu_processor(tmp_path, caplog):
    """``process.numchips=4`` on a CPU processor: the CPU is one
    device, so the count clamps to 1 with the JAX package's warning,
    and the flow runs the single-device path with its rows."""
    d = _conf(tmp_path)
    with caplog.at_level(logging.WARNING):
        clamped = FlowProcessor(_conf(tmp_path, **{"datax.job.process.numchips": "4"}),
                                batch_capacity=256, output_datasets=OUTPUTS,
                                device="cpu")
    assert "process.numchips=4 clamped to 1 visible devices" in caplog.text
    assert clamped.mesh is None and clamped.batch_capacity == 256
    single = FlowProcessor(d, batch_capacity=256, output_datasets=OUTPUTS, device="cpu")
    cols, valid = _cols(single)
    for (ds_c, m_c), (ds_s, _m) in zip(_run(clamped, cols, valid), _run(single, cols, valid)):
        assert ds_c == ds_s
        assert "Mesh_ICI_Bytes" not in m_c


def test_census_result_bytes_equal_the_gathered_tables(tmp_path):
    """The step gathers ``Hot`` (a sharded output, at the step boundary)
    and the 2 s window (the grouped ``PerDevice`` reads it whole), and
    sums the counts vector across the shards: the census's result
    bytes equal those tables' logical sizes at their capacities, to the
    byte, and ``Mesh_ICI_Bytes`` is their ring wire bytes over 8 shards."""
    mesh = make_mesh(8, devices=CPU8)
    proc = FlowProcessor(_conf(tmp_path), batch_capacity=256, mesh=mesh,
                         output_datasets=OUTPUTS)
    cols, valid = _cols(proc)
    (_ds, metrics), = _run(proc, cols, valid, batches=1)
    cap = proc.batch_capacity
    catalog = proc.pipeline.catalog
    window = "DataXProcessedInput_2seconds"
    gathered = (table_bytes(catalog["Hot"].types, cap)
                + table_bytes(catalog[window].types, proc.ring_slots["DataXProcessedInput"] * cap))
    # counts vector: the input count, per output its count and two
    # overflow slots, the projected count, and the windowed PerDevice's
    # window rows and groups: int32 each
    counts = 4 * (1 + 3 * len(OUTPUTS) + 1 + 2)
    census = proc.mesh_collectives.to_dict()
    assert census == {
        "all-gather": {"count": 2, "resultBytes": gathered},
        "all-reduce": {"count": 1, "resultBytes": counts},
    }
    assert metrics["Mesh_Reshard_Count"] == 3.0
    assert metrics["Mesh_ICI_Bytes"] == (
        allgather_wire_bytes(gathered, 8) + allreduce_wire_bytes(counts, 8))


def test_one_device_mesh_has_the_references_empty_census(tmp_path):
    """A one-device mesh runs no collective: the JAX package's census
    comes from a one-partition program, which holds none, and the
    port's step gathers nothing and sums no shards. Both export 0 for
    ``Mesh_ICI_Bytes`` and ``Mesh_Reshard_Count`` each batch, and the
    port's rows equal its single device's."""
    one = FlowProcessor(_conf(tmp_path), batch_capacity=256, output_datasets=OUTPUTS,
                        mesh=make_mesh(1, devices=("cpu",)))
    single = FlowProcessor(_conf(tmp_path), batch_capacity=256, output_datasets=OUTPUTS,
                           device="cpu")
    jone = JFlowProcessor(make_conf(tmp_path), batch_capacity=256, mesh=jmake_mesh(1),
                          output_datasets=OUTPUTS)
    cols, valid = _cols(single)
    for (ds_o, m_o), (ds_s, _m), (_ds_j, m_j) in zip(
            _run(one, cols, valid), _run(single, cols, valid), _jrun(jone, cols, valid)):
        assert ds_o == ds_s
        for key in ("Mesh_ICI_Bytes", "Mesh_Reshard_Count"):
            assert m_o[key] == m_j[key] == 0
    assert one.mesh_collectives.to_dict() == {}
    assert jone.mesh_collectives.op_count == 0
