"""The port's result path against the JAX package's: sized output
transfer (the EWMA-driven power-of-two capacity, the two-phase overflow
re-fetch and its headroom boost), the counts-only ``collect_counts``,
tables landed on a background thread, and the A/B output slots.

Each test feeds the same JSON bytes to the JAX ``FlowProcessor`` and to
the port's (on the CPU, through both packages' ``encode_json_bytes``) and
requires equal rows and equal ``Transfer_*`` metrics. The tests marked
``cuda`` need a card: the pool gate on the host-to-device copy, landed
tables against a blocking copy of the same slice, and one host-to-device
copy a step.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu.runtime.processor import transfer_buckets as jtransfer_buckets
from data_accelerator_tpu_torch.core.config import SettingDictionary
from data_accelerator_tpu_torch.runtime.processor import (
    OUTPUT_SLOT_BUFFERS,
    OVERFLOW_BOOST_BATCHES,
    FlowProcessor,
    transfer_buckets,
)

torch.set_num_threads(2)

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "k", "type": "long", "nullable": False, "metadata": {}},
    {"name": "v", "type": "double", "nullable": False, "metadata": {}},
]})
TRANSFORM = "--DataXQuery--\nOut = SELECT k, v FROM DataXProcessedInput\n"
TWO_OUT_TRANSFORM = TRANSFORM + (
    "--DataXQuery--\nOut2 = SELECT k FROM DataXProcessedInput WHERE v > 3\n"
)
BASE_MS = 1_700_000_000_000
# the metrics that measure wall clock
CLOCK_METRICS = ("Latency-Process", "Decode_RowsPerSec")


def _conf(extra=None, transform=TRANSFORM, capacity=4096):
    conf = {
        "datax.job.name": "SizedFlow",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": transform,
        "datax.job.process.batchcapacity": str(capacity),
    }
    conf.update(extra or {})
    return conf


def _pair(extra=None, transform=TRANSFORM, outputs=("Out",), device="cpu"):
    jp = JFlowProcessor(JSettingDictionary(_conf(extra, transform)),
                        output_datasets=list(outputs))
    tp = FlowProcessor(SettingDictionary(_conf(extra, transform)),
                       output_datasets=list(outputs), device=device)
    return jp, tp


def _bytes(n):
    return b"".join(
        b'{"k":%d,"v":%d.5}\n' % (i, i % 7) for i in range(n)
    )


def _dispatch(proc, n, b):
    t_ms = BASE_MS + 1000 * b
    return proc.dispatch_batch(proc.encode_json_bytes(_bytes(n), t_ms), t_ms)


def _same(jres, tres, what, transfer=True):
    """Equal rows and metrics; ``transfer=False`` leaves out the
    ``Transfer_*`` metrics."""
    (jd, jm), (td, tm) = jres, tres
    assert td == jd, what  # k, and v at .5, are exact in float32
    if not transfer:
        jm = {k: v for k, v in jm.items() if not k.startswith("Transfer_")}
        tm = {k: v for k, v in tm.items() if not k.startswith("Transfer_")}
    assert set(tm) <= set(jm), (what, set(tm) - set(jm))
    for k, v in tm.items():
        if k not in CLOCK_METRICS:
            assert v == jm[k], (what, k, jm[k], v)
    for k in jm:
        if k.startswith("Transfer_"):
            assert k in tm, (what, k)


def test_transfer_buckets_match_the_reference():
    for cap in (1, 256, 511, 512, 4096, 262_144):
        assert transfer_buckets(cap) == jtransfer_buckets(cap)


def test_sized_transfer_engages_after_observation():
    jp, tp = _pair()
    assert tp.sized_transfer
    results = []
    for b in range(2):
        jh, th = _dispatch(jp, 10, b), _dispatch(tp, 10, b)
        # first batch: no observations yet, full capacity; then pow2 >= 256
        assert th.fetch_caps == jh.fetch_caps == {"Out": (4096, 256)[b]}
        results.append(th.collect())
        _same(jh.collect(), results[-1], b)
    (_d1, m1), (d2, m2) = results
    assert len(d2["Out"]) == 10
    assert m2["Transfer_D2HBytes"] < m1["Transfer_D2HBytes"] / 4
    assert m2["Transfer_Efficiency"] > m1["Transfer_Efficiency"]
    assert "Transfer_Overflow_Count" not in m2


def test_overflow_refetch_matches_full_capacity_fetch():
    """A batch whose count exceeds the sized capacity returns exactly the
    rows of a full-capacity fetch, and the EWMA jumps past the count."""
    jp, tp = _pair()
    jfull, tfull = _pair({"datax.job.process.pipeline.sizedtransfer": "false"})
    assert not tfull.sized_transfer
    for proc in (jp, tp):
        proc.transfer_ewma["Out"] = 1.0  # force a 256-row sized cap
    jh, th = _dispatch(jp, 1000, 0), _dispatch(tp, 1000, 0)
    assert th.fetch_caps == {"Out": 256}  # undershoots the 1000 rows
    tres = th.collect()
    _same(jh.collect(), tres, "overflow")
    golden = _dispatch(tfull, 1000, 0).collect()
    _same(_dispatch(jfull, 1000, 0).collect(), golden, "full")
    assert tres[0]["Out"] == golden[0]["Out"]
    assert tres[1]["Transfer_Overflow_Count"] == 1.0
    jh, th = _dispatch(jp, 1000, 1), _dispatch(tp, 1000, 1)
    assert th.fetch_caps["Out"] >= 1000
    tres = th.collect()
    _same(jh.collect(), tres, "after")
    assert tres[0]["Out"] == golden[0]["Out"]
    assert "Transfer_Overflow_Count" not in tres[1]


def test_overflow_boosts_headroom_for_following_batches():
    jp, tp = _pair()
    for proc in (jp, tp):
        proc.transfer_ewma["Out"] = 1.0
    _same(_dispatch(jp, 1000, 0).collect(), _dispatch(tp, 1000, 0).collect(), 0)
    # set at overflow, burned once by this batch's own observation
    assert tp.transfer_boost["Out"] == jp.transfer_boost["Out"] == (
        OVERFLOW_BOOST_BATCHES - 1)
    big = 1 << 20
    boosted = tp.transfer_capacity("Out", big)
    assert boosted == jp.transfer_capacity("Out", big)
    tp.transfer_boost["Out"] = 0
    plain = tp.transfer_capacity("Out", big)
    assert boosted == 2 * plain  # doubled headroom, same pow2 ladder
    tp.transfer_boost["Out"] = 2
    tp.observe_transfer_counts({"Out": 1000})
    tp.observe_transfer_counts({"Out": 1000})
    assert tp.transfer_boost["Out"] == 0
    assert tp.transfer_capacity("Out", big) == plain
    # the following batches ride the boost in both packages
    for b in range(1, 4):
        jh, th = _dispatch(jp, 900, b), _dispatch(tp, 900, b)
        assert th.fetch_caps == jh.fetch_caps
        _same(jh.collect(), th.collect(), b)


def test_collect_counts_is_cheap_and_idempotent():
    jp, tp = _pair()
    jh, th = _dispatch(jp, 10, 0), _dispatch(tp, 10, 0)
    bc = th.collect_counts()
    assert bc.dataset_counts == {"Out": 10}
    assert np.array_equal(bc.counts, jh.collect_counts().counts)
    assert bc.counts.nbytes < 1024
    assert th.collect_counts() is bc  # the sync point, paid once
    tres = th.collect_tables()
    _same(jh.collect_tables(), tres, "tables")
    assert tres[1]["Sync_CountsBytes"] == float(bc.counts.nbytes)


@pytest.mark.parametrize("slots", ["true", "false"])
def test_background_landing_rows_match_sync_collect(slots):
    """Counts on the dispatching thread and tables on a landing thread,
    which lands batch N while the reference runs batch N + 1: the rows
    and metrics of the JAX package's synchronous collect. Batch N lands
    before the port encodes batch N + 1, as in the reference's order:
    on the CPU a landing gives its ingest matrix back, and whether the
    next encode reuses it (``Decode_BufferReuse_Count``) must not depend
    on which thread gets there first. The ``Transfer_*`` metrics are
    left out: batch N+1's sized capacity depends on whether batch N's
    landing fed the EWMA before N+1 was dispatched, which the landing
    thread decides."""
    extra = {"datax.job.process.pipeline.outputslots": slots}
    jp, tp = _pair(extra)
    seqs = [37, 301, 5, 301, 64, 900, 12]
    with ThreadPoolExecutor(1, thread_name_prefix="landing") as pool:
        prev, reuses = None, []
        for b, n in enumerate(seqs):
            golden = _dispatch(jp, n, b).collect()
            if prev is not None:
                # batch b - 1 has landed (its matrix is back in the
                # pool, its reuses counted) before batch b's encode
                landed = prev[0].result(timeout=60)
                _same(prev[1], landed, b - 1, transfer=False)
                reuses.append(landed[1].get("Decode_BufferReuse_Count"))
            h = _dispatch(tp, n, b)
            h.collect_counts()  # the dispatching thread's only block
            fut = pool.submit(h.collect_tables)
            prev = (fut, golden)
        _same(prev[1], prev[0].result(timeout=60), "last", transfer=False)
    # every encode after the first took the matrix its predecessor gave back
    assert reuses == [None] + [1.0] * (len(seqs) - 2)


def test_output_slots_rotate_and_stay_correct():
    jp, tp = _pair()
    jplain, tplain = _pair({"datax.job.process.pipeline.outputslots": "false",
                            "datax.job.process.pipeline.sizedtransfer": "false"})
    assert tp.output_slots_enabled and not tplain.output_slots_enabled
    for b, n in enumerate([10, 20, 30, 40, 50]):
        tres = _dispatch(tp, n, b).collect()
        _same(_dispatch(jp, n, b).collect(), tres, b)
        assert tres[0] == _dispatch(tplain, n, b).collect()[0]
        _dispatch(jplain, n, b).collect()
    # after the first (full-capacity) batch the sized cap settles at 256
    ring = tp._slots[("Out", 256)]
    assert len(ring) == OUTPUT_SLOT_BUFFERS
    assert tp._slot_parity["Out"] % OUTPUT_SLOT_BUFFERS == 1
    for dev, host, landed in ring:
        assert landed.is_set() and host is None  # the CPU lands in place
        assert dev.valid.shape == (256,)


def test_slots_are_written_in_place_once_landed():
    _jp, tp = _pair()
    # the parity advances once a batch: batch 0 (full capacity) took A,
    # batch 1 takes (Out, 256) B
    for b in range(2):
        _dispatch(tp, 10, b).collect()
    first = tp._slots[("Out", 256)][1][0]
    for b in range(2, 4):  # A, then B again: the same buffers
        _dispatch(tp, 10, b).collect()
    assert tp._slots[("Out", 256)][1][0] is first


def test_slot_contention_falls_back_to_fresh_buffers():
    """A slot whose last batch has not landed is never written: the
    dispatch takes fresh buffers (counted) instead."""
    jp, tp = _pair()
    jhs, ths = [], []
    for b in range(OUTPUT_SLOT_BUFFERS + 1):
        jhs.append(_dispatch(jp, 8, b))
        ths.append(_dispatch(tp, 8, b))
    tres = [h.collect() for h in ths]
    for b, (jh, res) in enumerate(zip(jhs, tres)):
        _same(jh.collect(), res, b)
    contended = sum(m.get("Transfer_SlotContended_Count", 0.0) for _d, m in tres)
    assert contended == 1.0
    for d, _m in tres:
        assert len(d["Out"]) == 8


def test_abandoned_batch_frees_its_slot():
    _jp, tp = _pair()
    _dispatch(tp, 8, 0).collect()
    h = _dispatch(tp, 8, 1)  # slot (Out, 256) B
    h.abandon()
    assert tp._slots[("Out", 256)][1][2].is_set()
    _d, m = _dispatch(tp, 8, 2).collect()  # slot A, free
    _d, m = _dispatch(tp, 8, 3).collect()  # slot B, abandoned: free too
    assert "Transfer_SlotContended_Count" not in m


def test_two_outputs_rows_and_bytes_match():
    jp, tp = _pair(transform=TWO_OUT_TRANSFORM, outputs=("Out", "Out2"))
    for b, n in enumerate([5, 400, 40]):
        _same(_dispatch(jp, n, b).collect(), _dispatch(tp, n, b).collect(), b)


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pool_matrix_is_gated_on_its_h2d_copy_on_card(cuda_device):
    tp = FlowProcessor(SettingDictionary(_conf()), output_datasets=["Out"])
    raw = tp.encode_json_bytes(_bytes(100), BASE_MS, to_device=False)
    pool, mat = raw.ingest_slot
    assert pool.pin and mat.is_pinned() and not raw.data.is_cuda
    h = tp.dispatch_batch(raw, BASE_MS)
    ((owner, owned, copied),) = h._ingest  # one source, one matrix
    assert owner is pool and owned is mat
    assert isinstance(copied, torch.cuda.Event)
    other = pool.acquire()  # the batch still owns the matrix
    assert other is not mat
    h.collect_counts()  # gives the matrix back, gated on its copy
    assert h._ingest == [] and copied.query()
    assert pool.acquire() is mat
    h.collect_tables()


@pytest.mark.cuda
def test_landed_tables_equal_a_blocking_copy_on_card(cuda_device):
    """Every landed host table equals a blocking .cpu() of the same
    device slice, batch after batch, slots rotating: a read of the
    pinned buffers before their copy's event would not."""
    gpu = FlowProcessor(SettingDictionary(_conf(capacity=262_144)),
                        output_datasets=["Out"])
    cpu = FlowProcessor(SettingDictionary(_conf(capacity=262_144)),
                        output_datasets=["Out"], device="cpu")
    for b, n in enumerate([200_000, 1000, 1000, 5000, 1000, 262_144]):
        h = _dispatch(gpu, n, b)
        h.collect_counts()
        h._tables_event.synchronize()
        for name, t in h.fetch_tables.items():
            host = h.fetch_hosts[name]
            assert torch.equal(host.valid, t.valid.cpu())
            for c, v in t.cols.items():
                assert torch.equal(host.cols[c], v.cpu()), (b, c)
        d, m = h.collect_tables()
        cd, cm = _dispatch(cpu, n, b).collect()
        assert d == cd, b
        for k in ("Transfer_D2HBytes", "Transfer_Efficiency"):
            assert m[k] == cm[k], (b, k)


@pytest.mark.cuda
def test_one_h2d_copy_per_step_on_card(cuda_device, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tp = FlowProcessor(SettingDictionary(_conf(capacity=65_536)),
                       output_datasets=["Out"])
    for b in range(3):  # the dictionary and the slots settle
        _dispatch(tp, 1000, b).collect()
    raw = tp.encode_json_bytes(_bytes(1000), BASE_MS + 3000, to_device=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp.dispatch_batch(raw, BASE_MS + 3000).collect_counts()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    copies = [e for e in json.loads(trace.read_text())["traceEvents"]
              if "HtoD" in e.get("name", "")]
    assert len(copies) == 1, copies
    assert copies[0]["args"]["bytes"] == raw.data.numel() * 4
