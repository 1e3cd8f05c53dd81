"""The port's fleet telemetry plane against the JAX package's: the frame
publisher (``obs/publisher.py``) and the fleet view with its DX54x
delivery audit (``obs/fleetview.py``), each case of ``test_fleetview.py``
run on both packages (less the REST routes of the control plane, not
ported yet), and the port's ``StreamingHost`` publishing the JAX host's
frames for one conf and one source, batch for batch, less the metrics
that measure time. Both hosts arm the protocol monitor too, and record
the same sequences."""

import json
import types

import numpy as np
import pytest

from data_accelerator_tpu.obs import fleetview as jfleet
from data_accelerator_tpu.obs import histogram as jhist
from data_accelerator_tpu.obs import publisher as jpub
from data_accelerator_tpu.obs.__main__ import stitch_lineage as jstitch
from data_accelerator_tpu_torch.obs import fleetview as tfleet
from data_accelerator_tpu_torch.obs import histogram as thist
from data_accelerator_tpu_torch.obs import publisher as tpub
from data_accelerator_tpu_torch.obs.__main__ import stitch_lineage as tstitch
from data_accelerator_tpu_torch.serve.objectstore import ObjectStoreClient, ObjectStoreServer

PKGS = {
    "jax": types.SimpleNamespace(fleet=jfleet, hist=jhist, pub=jpub, stitch=jstitch),
    "torch": types.SimpleNamespace(fleet=tfleet, hist=thist, pub=tpub, stitch=tstitch),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class DictStore:
    """In-memory stand-in for ObjectStoreClient (put/get/list)."""

    _fleet_prefix = ""

    def __init__(self):
        self.data = {}

    def put(self, key, content):
        self.data[key] = content

    def get(self, key):
        return self.data.get(key)

    def list(self, prefix=""):
        return [k for k in self.data if k.startswith(prefix)]


def _observed(seed, n, scale):
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, scale, size=n) + 0.05).tolist()


# -- LatencyHistogram.merge exactness -----------------------------------------
def test_merge_percentiles_exact_over_union(pkg):
    samples = [_observed(s, 40, sc) for s, sc in ((1, 3.0), (2, 40.0))]
    hists = []
    for obs in samples:
        h = pkg.hist.LatencyHistogram()
        for v in obs:
            h.observe(v)
        hists.append(h)
    merged = hists[0].merge(hists[1])
    union = np.concatenate(samples)
    for q in (50, 90, 95, 99):
        assert merged.percentile(q) == pytest.approx(float(np.percentile(union, q)), rel=1e-9)
    assert merged.count == len(union)
    assert merged.sum_ms == pytest.approx(float(union.sum()))


def test_merge_associative_and_commutative_over_three_replicas(pkg):
    samples = [_observed(s, 30, sc) for s, sc in ((3, 2.0), (4, 15.0), (5, 80.0))]
    a, b, c = [pkg.hist.LatencyHistogram() for _ in range(3)]
    for h, obs in zip((a, b, c), samples):
        for v in obs:
            h.observe(v)
    left, right, swapped = a.merge(b).merge(c), a.merge(b.merge(c)), c.merge(a).merge(b)
    union = np.concatenate(samples)
    for q in (50, 95, 99):
        want = float(np.percentile(union, q))
        for h in (left, right, swapped):
            assert h.percentile(q) == pytest.approx(want, rel=1e-9)
    assert left.count == right.count == swapped.count == len(union)
    assert left.to_state()["counts"] == right.to_state()["counts"] \
        == swapped.to_state()["counts"]


def test_histogram_states_cross_packages():
    """A histogram state one package wrote is the other's: frames of
    either package merge in one view."""
    h = jhist.LatencyHistogram()
    for v in _observed(6, 25, 10.0):
        h.observe(v)
    back = thist.LatencyHistogram.from_state(h.to_state())
    assert back.to_state() == h.to_state()
    assert jhist.LatencyHistogram.from_state(back.to_state()).to_state() == h.to_state()


# -- publisher -> frames -> FleetView golden rollup ------------------------------
def _publisher(pkg, store, replica, index, count=2, flow="GoldFlow"):
    return pkg.pub.TelemetryFramePublisher(
        url="objstore://unused/dxtpu", flow=flow, replica=replica,
        replica_index=index, replica_count=count, window_s=0.0,
        histograms=pkg.hist.HistogramRegistry(), client=store,
    )


def _golden_rollup(pkg):
    store = DictStore()
    obs_by_rep = {"r1": _observed(7, 35, 5.0), "r2": _observed(8, 35, 50.0)}
    per_rep_counters = {"r1": 3, "r2": 5}
    for rep, index in (("r1", 1), ("r2", 2)):
        pub = _publisher(pkg, store, rep, index)
        for i in range(per_rep_counters[rep]):
            pub.record_batch(
                {"Input_default_Events_Count": 4.0, "Output_Out_Events_Count": 4.0,
                 "Batch_ProcessedMs": 12.5},
                consumed={("default", 0): (i * 4, i * 4 + 4)},
                batch_time_ms=1000 + i,
            )
        for v in obs_by_rep[rep]:
            pub.histograms.observe("GoldFlow", "process", v)
        assert pub.flush(final=True)
    view = pkg.fleet.FleetView(client=store)
    assert view.refresh() > 0
    return view, obs_by_rep, sum(per_rep_counters.values())


def test_two_replica_rollup_golden_equal(pkg):
    view, obs_by_rep, total_batches = _golden_rollup(pkg)
    fm = view.fleet_metrics("GoldFlow")
    assert fm["counters"]["Input_default_Events_Count"] == 4.0 * total_batches
    assert fm["counters"]["Output_Out_Events_Count"] == 4.0 * total_batches
    for metric in ("Input_default_Events_Count", "Output_Out_Events_Count"):
        assert fm["counters"][metric] == sum(
            fm["replicas"][r]["counters"][metric] for r in ("r1", "r2"))
    union = np.concatenate(list(obs_by_rep.values()))
    merged = view.histograms.get("GoldFlow", "process")
    for q in (50, 99):
        assert merged.percentile(q) == pytest.approx(float(np.percentile(union, q)), rel=1e-9)
    assert all(r["status"] == "completed" for r in fm["replicas"].values())
    assert fm["audit"]["conserved"]
    assert fm["audit"]["counts"] == {"DX540": 0, "DX541": 0, "DX542": 0}
    assert fm["replicas"]["r1"]["offsets"]["default:0"] == [0, 12]


def test_rollups_of_the_two_packages_are_equal():
    views = {name: _golden_rollup(p)[0] for name, p in PKGS.items()}

    def stable(fm):
        fm = dict(fm)
        for rep in fm["replicas"].values():
            rep.pop("lastSeenMs")
        fm["lineage"] = [{k: v for k, v in seg.items() if not k.endswith("SeenMs")}
                         for seg in fm["lineage"]]
        return fm

    assert stable(views["torch"].fleet_metrics("GoldFlow")) == \
        stable(views["jax"].fleet_metrics("GoldFlow"))


def test_counter_gauge_classification(pkg):
    assert pkg.pub.is_counter_metric("Input_default_Events_Count")
    assert pkg.pub.is_counter_metric("Kafka_Fetch_Bytes")
    assert not pkg.pub.is_counter_metric("Batch_ProcessedMs")
    assert not pkg.pub.is_counter_metric("Pipeline_Depth")


# -- fail-open ----------------------------------------------------------------
class FlakyStore(DictStore):
    def __init__(self):
        super().__init__()
        self.vanished = set()

    def get(self, key):
        if key in self.vanished:
            return None
        return super().get(key)


def _good_frame(window=0, replica="r1", flow="FailOpen", **extra):
    frame = {
        "version": 1, "flow": flow, "replica": replica, "window": window,
        "counters": {"Input_default_Events_Count": 2.0}, "batches": 1,
        "publishedAtMs": 1000 + window,
    }
    frame.update(extra)
    return frame


def test_corrupt_frames_skipped_and_counted_never_crash(pkg):
    store = FlakyStore()
    store.put("fleet/FailOpen/r1/00000000.json", json.dumps(_good_frame(0)).encode())
    store.put("fleet/FailOpen/r1/00000001.json", json.dumps(_good_frame(1)).encode()[:25])
    store.put("fleet/FailOpen/r1/00000002.json", b"\x00\xff garbage")
    store.put("fleet/FailOpen/r1/00000003.json", b"[1,2,3]")
    store.put("fleet/FailOpen/r1/00000004.json",
              json.dumps({"flow": "FailOpen", "replica": "r1"}).encode())
    store.put("fleet/FailOpen/r1/00000005.json",
              json.dumps(_good_frame(5, version=99)).encode())
    store.put("fleet/FailOpen/r1/00000006.json", json.dumps(_good_frame(6)).encode())
    store.vanished.add("fleet/FailOpen/r1/00000006.json")
    store.put("fleet/FailOpen/r1/00000007.json", json.dumps(_good_frame(7)).encode())
    view = pkg.fleet.FleetView(client=store)
    assert view.refresh() == 2
    assert view.decode_errors == 6
    assert view.fleet_metrics("FailOpen")["counters"]["Input_default_Events_Count"] == 4.0
    assert view.refresh() == 0
    assert view.decode_errors == 6


def test_unlistable_store_yields_zero_not_crash(pkg):
    class DownStore(DictStore):
        def list(self, prefix=""):
            raise OSError("store unreachable")

    assert pkg.fleet.FleetView(client=DownStore()).refresh() == 0


def test_publisher_fail_open_retains_window_across_outage(pkg):
    class OutageStore(DictStore):
        def __init__(self):
            super().__init__()
            self.down = True

        def put(self, key, content):
            if self.down:
                raise OSError("store down")
            super().put(key, content)

    store = OutageStore()
    pub = _publisher(pkg, store, "r1", 1, count=1, flow="Outage")
    pub.record_batch({"Input_default_Events_Count": 3.0}, batch_time_ms=1)
    assert pub.publish_errors == 1
    assert not store.data
    store.down = False
    pub.record_batch({"Input_default_Events_Count": 5.0}, batch_time_ms=2)
    (body,) = store.data.values()
    assert json.loads(body)["counters"]["Input_default_Events_Count"] == 8.0
    assert pub.frames_published == 1


def test_kill_suppresses_final_frame(pkg):
    store = DictStore()
    pub = _publisher(pkg, store, "r1", 1, count=1, flow="Killed")
    pub.record_batch({"Input_default_Events_Count": 1.0}, batch_time_ms=1)
    assert pub.flush()
    pub.kill()
    assert not pub.flush(final=True)
    frames = [json.loads(v) for v in store.data.values()]
    assert len(frames) == 1 and not frames[0]["final"]


# -- DX54x delivery-conservation audit -----------------------------------------
def test_dropped_batch_fires_dx540_exactly_once(pkg):
    view = pkg.fleet.FleetView(client=DictStore())
    view.ingest_frame(_good_frame(0, flow="Lossy", final=True, delivery={
        "ingested": {"default": 10.0}, "emitted": {"Out": 6.0}}))
    for _ in range(3):
        audit = view.audit("Lossy")
        assert audit["counts"]["DX540"] == 1 and audit["counts"]["DX541"] == 0
        assert not audit["conserved"]
        (ev,) = [e for e in audit["events"] if e["code"] == "DX540"]
        assert ev["ingested"] == 10.0 and ev["emitted"] == 6.0


def test_duplication_fires_dx541(pkg):
    view = pkg.fleet.FleetView(client=DictStore())
    view.ingest_frame(_good_frame(0, flow="Dup", final=True, delivery={
        "ingested": {"default": 4.0}, "emitted": {"Out": 7.0}}))
    assert view.audit("Dup")["counts"] == {"DX540": 0, "DX541": 1, "DX542": 0}


def test_audited_output_defaults_to_busiest_and_is_overridable(pkg):
    view = pkg.fleet.FleetView(client=DictStore())
    view.ingest_frame(_good_frame(0, flow="TwoOut", final=True, delivery={
        "ingested": {"default": 10.0}, "emitted": {"Out": 10.0, "Win": 3.0}}))
    assert view.audit("TwoOut")["conserved"]
    assert view.audit("TwoOut", output="Win")["counts"]["DX540"] == 1


def test_stale_replica_fires_dx542_and_final_marker_completes(pkg):
    now = {"t": 100.0}
    view = pkg.fleet.FleetView(client=DictStore(), now_fn=lambda: now["t"])
    delivery = {"ingested": {"default": 2.0}, "emitted": {"Out": 2.0}}
    view.ingest_frame(_good_frame(0, replica="drained", flow="Stale", windowSeconds=1.0,
                                  publishedAtMs=50_000, final=True, delivery=delivery))
    view.ingest_frame(_good_frame(0, replica="vanished", flow="Stale", windowSeconds=1.0,
                                  publishedAtMs=50_000, delivery=delivery))
    now["t"] = 51.0
    fm = view.fleet_metrics("Stale")
    assert fm["replicas"]["vanished"]["status"] == "live"
    assert fm["audit"]["counts"]["DX542"] == 0
    now["t"] = 60.0
    fm = view.fleet_metrics("Stale")
    assert fm["replicas"]["drained"]["status"] == "completed"
    assert fm["replicas"]["vanished"]["status"] == "stale"
    assert fm["staleReplicas"] == ["vanished"]
    (ev,) = [e for e in fm["audit"]["events"] if e["code"] == "DX542"]
    assert ev["replica"] == "vanished"
    assert fm["audit"]["conserved"]


# -- lineage + surfaces ----------------------------------------------------------
def test_lineage_prefers_registry_records_falls_back_to_frames(pkg):
    records = [{"replica": "base", "replicaIndex": 1}]
    view = pkg.fleet.FleetView(client=DictStore(), lineage_fn=lambda flow: records)
    view.ingest_frame(_good_frame(0, replica="g0-r1", flow="Lin", publishedAtMs=1000))
    view.ingest_frame(_good_frame(0, replica="g1-r1", flow="Lin", publishedAtMs=2000))
    assert view.lineage("Lin") == records

    def broken(flow):
        raise OSError("registry down")

    view.lineage_fn = broken
    assert [seg["replica"] for seg in view.lineage("Lin")] == ["g0-r1", "g1-r1"]
    view.lineage_fn = None  # the port has no job registry yet: frames alone
    assert [seg["replica"] for seg in view.lineage("Lin")] == ["g0-r1", "g1-r1"]


def test_fleet_prometheus_rollup_renders(pkg):
    view = pkg.fleet.FleetView(client=DictStore())
    view.ingest_frame(_good_frame(0, flow="Promo", final=True, delivery={
        "ingested": {"default": 2.0}, "emitted": {"Out": 2.0}}))
    text = pkg.fleet.render_fleet_prometheus(view)
    assert 'datax_fleet_metric_total{flow="Promo"' in text
    assert "datax_fleet_replicas{" in text
    assert "datax_fleet_frame_decode_errors_total 0" in text
    other = PKGS["jax" if pkg is PKGS["torch"] else "torch"]
    view2 = other.fleet.FleetView(client=DictStore())
    view2.ingest_frame(_good_frame(0, flow="Promo", final=True, delivery={
        "ingested": {"default": 2.0}, "emitted": {"Out": 2.0}}))
    assert other.fleet.render_fleet_prometheus(view2) == text


def test_obs_trace_stitch_groups_by_replica_tag(pkg):
    spans = [
        {"trace": "t1", "span": "a", "startTs": 1.0,
         "properties": {"replica": "g0-r1", "batchTime": 1}},
        {"trace": "t1", "span": "b", "parent": "a", "startTs": 1.1, "properties": {}},
        {"trace": "t2", "span": "c", "startTs": 5.0,
         "properties": {"replica": "g1-r1", "batchTime": 2}},
        {"trace": "t3", "span": "d", "startTs": 3.0,
         "properties": {"replica": "g0-r1", "batchTime": 3}},
    ]
    segments = pkg.stitch(spans, ["t1", "t2", "t3"])
    assert [rep for rep, _ in segments] == ["g0-r1", "g1-r1"]
    assert segments[0][1] == ["t1", "t3"]
    assert segments[1][1] == ["t2"]


# -- both hosts publish the same frames ---------------------------------------------
HOST_BATCHES = 6


@pytest.fixture
def objstore():
    srv = ObjectStoreServer().start()
    yield srv
    srv.stop()


def _published_run(pkg, url, flow, monkeypatch, ckpt_dir):
    """One host of ``pkg`` publishing every batch's frame to ``url``
    under the pinned clock of ``test_torch_host``, the protocol monitor
    armed; returns the host, stopped."""
    from test_torch_host import (
        _BytesSource,
        _Clock,
        _feed,
        _host_conf,
        _RecordingSink,
    )
    from data_accelerator_tpu.core.config import SettingDictionary as JSD
    from data_accelerator_tpu.obs.histogram import HISTOGRAMS as JH
    from data_accelerator_tpu.runtime import host as jhost_mod
    from data_accelerator_tpu.runtime import sinks as jsinks
    from data_accelerator_tpu_torch.core.config import SettingDictionary
    from data_accelerator_tpu_torch.obs.histogram import HISTOGRAMS as TH
    from data_accelerator_tpu_torch.runtime import host as thost_mod
    from data_accelerator_tpu_torch.runtime import sinks as tsinks

    mod, sinks, SD, hists = {
        "jax": (jhost_mod, jsinks, JSD, JH),
        "torch": (thost_mod, tsinks, SettingDictionary, TH),
    }[pkg]
    hists.clear()
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock.module())
    conf = _host_conf(flow, pkg, {
        "datax.job.process.fleet.publishurl": url,
        "datax.job.process.fleet.windowseconds": "0",
        "datax.job.process.debug.protocolmonitor": "true",
        "datax.job.input.default.eventhub.checkpointdir": ckpt_dir,
        "datax.job.input.default.eventhub.checkpointinterval": "1 second",
    })
    _kind, lines = _feed("bytes")
    kw = {"device": "cpu"} if pkg == "torch" else {}
    host = mod.StreamingHost(SD(conf), source=_BytesSource(list(lines), clock), **kw)
    sink = _RecordingSink()
    host.dispatcher = sinks.OutputDispatcher(
        {n: sinks.OutputOperator(n, [sink]) for n in ("OpenDoors", "HeatAvg", "AnomalyAlerts")},
        host.metric_logger)
    try:
        host.run(max_batches=HOST_BATCHES)
    finally:
        host.stop()
        monkeypatch.undo()
    return host


PORT_ONLY_STAGES = {"poll", "tail", "pace", "window-group"}


def _frames(client, flow):
    return [json.loads(client.get(k)) for k in sorted(client.list(f"fleet/{flow}/"))]


def _comparable(frame):
    """A frame less what measures time: wall-clock stamps, timing
    metrics, health's clock fields, histogram samples (their counts
    stay)."""
    from test_torch_host import TIMING_METRICS

    keep = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if not k.startswith(TIMING_METRICS + ("Decode_RowsPerSec",))}
    health = frame["health"] or {}
    return {
        **{k: v for k, v in frame.items()
           if k not in ("publishedAtMs", "counters", "gauges", "histograms", "health")},
        "counters": keep(frame["counters"]),
        "gauges": keep(frame["gauges"]),
        "histograms": {s: sum(h["counts"]) for s, h in frame["histograms"].items()},
        "health": {k: health.get(k) for k in ("status", "flow", "batchesProcessed",
                                              "batchesFailed", "lastBatchTimeMs")},
    }


def test_hosts_publish_the_same_frames_batch_for_batch(objstore, monkeypatch, tmp_path):
    from data_accelerator_tpu_torch.runtime.processor import window_groups
    from test_torch_flow import PORT_GROUP_METRICS

    flow = "FleetParity"
    hosts, frames = {}, {}
    for pkg in ("jax", "torch"):
        url = f"objstore://127.0.0.1:{objstore.port}/{pkg}"
        hosts[pkg] = _published_run(pkg, url, flow, monkeypatch, str(tmp_path / pkg))
        frames[pkg] = _frames(ObjectStoreClient(objstore.endpoint, pkg), flow)
    # one frame a batch (window 0 s), then the stop's final drain marker
    assert len(frames["torch"]) == HOST_BATCHES + 1
    assert [f["final"] for f in frames["torch"]] == [False] * HOST_BATCHES + [True]
    assert [f["replica"] for f in frames["torch"]] == ["r1"] * (HOST_BATCHES + 1)
    proc = hosts["torch"].processor
    counts_extra = 8 * len(window_groups(proc.pipeline, proc.windows))
    for b, (t, j) in enumerate(zip(frames["torch"], frames["jax"])):
        ct, cj = _comparable(t), _comparable(j)
        # the port's own spans, the source's poll, the batch's tail and
        # the pacing sleep, feed histograms the JAX host has no span for
        extra = set(ct["histograms"]) - set(cj["histograms"])
        assert "poll" in extra and extra <= PORT_ONLY_STAGES, (b, extra)
        for stage in extra:
            del ct["histograms"][stage]
        # the port's own counters of the flow's windowed GROUP BY, and its
        # counts vector's two more int32 entries for it
        for kind in ("counters", "gauges"):
            for k in PORT_GROUP_METRICS & set(ct[kind]):
                del ct[kind][k]
            for k in ("Transfer_D2HBytes", "Sync_CountsBytes"):
                if k in ct[kind]:
                    ct[kind][k] -= counts_extra
        assert ct == cj, (b, {k: (ct[k], cj[k]) for k in ct if ct[k] != cj.get(k)})
    assert len(frames["torch"]) == len(frames["jax"])
    first = frames["torch"][0]
    assert first["counters"]["Protocol_Events_Count"] > 0
    assert "Calib_HbmReadGBps" in first["gauges"]
    assert first["delivery"]["ingested"] and first["watermark"]["offsets"]
    # the protocol monitors sealed the same sequences, without a violation
    tpm, jpm = hosts["torch"].protocol_monitor, hosts["jax"].protocol_monitor
    assert tpm.recent_sequences() == jpm.recent_sequences()
    assert tpm.batches_sealed == HOST_BATCHES and tpm.violations == 0
    kinds = {e["kind"] for s in tpm.recent_sequences() for e in s["sequence"]}
    assert {"SINK_EMIT", "POINTER_FLIP", "FIFO_ACK", "DURABLE_WRITE",
            "OFFSET_COMMIT"} <= kinds
    # the views of both stores agree: counters, statuses, the audit
    views = {}
    for pkg in ("jax", "torch"):
        view = tfleet.FleetView(client=ObjectStoreClient(objstore.endpoint, pkg))
        assert view.refresh() == HOST_BATCHES + 1
        views[pkg] = view.fleet_metrics(flow)
    for key in ("audit", "staleReplicas"):
        assert views["torch"][key] == views["jax"][key]
    assert views["torch"]["replicas"]["r1"]["status"] == "completed"
    # the audit judges the busiest output, OpenDoors, which does not
    # pass every input row through (a filter): the same verdict on both
    assert views["torch"]["audit"]["ingested"] == float(sum(
        f["delivery"]["ingested"].get("DataXProcessedInput", 0.0)
        for f in frames["torch"]))
