"""The port's device-plan tier (``analysis/deviceplan.py``) and its cost
model's byte and FLOP forms (``analysis/costmodel.py``), against the
JAX package's ``tests/test_deviceplan.py``.

- The closed forms against hand-computed shapes (the reference's
  cases, less the ICI ones: the port prices one card).
- The drift gate: for every baseline transform, and for the main flow's
  processor (chip_smoke's alerting flow plus the anomaly query) at
  capacity 64, the port's per-stage model bytes, its meta evaluation
  and the tensors a real run materializes are equal, exactly; and the
  per-stage bytes, FLOPs and transients equal the JAX package's at 1
  chip.
- The meta evaluation allocates nothing: every tensor an op makes
  during it lies on ``meta``.
- ``chips`` above 1 is refused, naming slice 8.
- The slots a processor holds: none with its output slots off.
- Sampled cardinality feeds the DX200/DX202 lints, as in the reference.
- An armed processor (``process.debug.*``) analyzes like an unarmed one.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from data_accelerator_tpu.analysis import deviceplan as jax_deviceplan
from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.analysis import analyze_flow_device
from data_accelerator_tpu_torch.analysis.costmodel import (
    output_slot_bytes,
    row_bytes,
    stage_flops,
    stage_transient_bytes,
    table_bytes,
    view_output_bytes,
)
from data_accelerator_tpu_torch.analysis.deviceplan import (
    analyze_processor,
    flow_plan_from_processor,
    materialized_stage_bytes,
)
from data_accelerator_tpu_torch.compile.planner import JoinSite, StagePlan
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.ops.join import RESIDUAL_BLOCK_PAIRS
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor

torch.set_num_threads(2)

SCHEMA = json.dumps({"type": "struct", "fields": [
    {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
    {"name": "temperature", "type": "double", "nullable": False,
     "metadata": {}},
    {"name": "eventTimeStamp", "type": "timestamp", "nullable": False,
     "metadata": {"useCurrentTimeMillis": True}},
]})


# ---------------------------------------------------------------------------
# closed forms vs hand-computed shapes
# ---------------------------------------------------------------------------
def test_table_bytes_by_width():
    # 100 rows: long 4B + double 4B + boolean 1B + valid 1B per row
    types = {"a": "long", "b": "double", "c": "boolean"}
    assert table_bytes(types, 100) == 400 + 400 + 100 + 100
    assert row_bytes(types) == 4 + 4 + 1 + 1


def test_view_output_bytes_overflow_columns():
    types = {"k": "long", "c": "long"}
    rows = 64
    base = 4 * rows + 4 * rows + rows  # two int32 cols + valid
    grouped = StagePlan(kind="group", input_rows=256, output_rows=rows,
                        grouped=True, groups_bound=rows)
    assert view_output_bytes(types, grouped, rows) == base + 4 * rows
    site = JoinSite(kind="INNER", right_table="r", left_rows=256,
                    right_rows=64, out_rows=rows, algorithm="sort-merge",
                    n_eq_keys=1, has_residual=False)
    joined = StagePlan(kind="project", input_rows=rows, output_rows=rows,
                       joins=(site,))
    assert view_output_bytes(types, joined, rows) == base + 4 * rows
    union = StagePlan(kind="union", input_rows=2 * rows, output_rows=rows,
                      joins=(site,), union_branches=2)
    assert view_output_bytes(types, union, rows) == base
    assert view_output_bytes(types, None, rows) == base
    # the A/B transfer slots: two copies of the output layout, or fewer
    assert output_slot_bytes(types, grouped, rows) == 2 * (base + 4 * rows)
    assert output_slot_bytes(types, grouped, rows, buffers=1) == base + 4 * rows


def test_flops_match_matrix_dominates():
    site = JoinSite(kind="INNER", right_table="w", left_rows=1 << 12,
                    right_rows=1 << 14, out_rows=1 << 14,
                    algorithm="match-matrix", n_eq_keys=1, has_residual=True)
    p = StagePlan(kind="project", input_rows=1 << 14, output_rows=1 << 14,
                  joins=(site,))
    assert stage_flops(p, 3) >= (1 << 26) * 2
    # the [n, m] mask, the residual's [n, m] result, and one block of
    # two gathered 4-byte operands (the port's block-wise residual)
    assert stage_transient_bytes(p) == (1 << 26) * 2 + 8 * RESIDUAL_BLOCK_PAIRS
    plain = JoinSite(**{**site.__dict__, "has_residual": False})
    assert stage_transient_bytes(
        StagePlan(kind="project", input_rows=1, output_rows=1, joins=(plain,))
    ) == 1 << 26


def test_flops_sort_merge_is_loglinear():
    site = JoinSite(kind="INNER", right_table="w", left_rows=1 << 12,
                    right_rows=1 << 14, out_rows=1 << 14,
                    algorithm="sort-merge", n_eq_keys=1, has_residual=False)
    p = StagePlan(kind="project", input_rows=1 << 14, output_rows=1 << 14,
                  joins=(site,))
    nm = (1 << 12) + (1 << 14)
    assert stage_flops(p, 3) < nm * 20 + (1 << 14) + (1 << 14) * 3 + 1
    assert stage_transient_bytes(p) == 0


# ---------------------------------------------------------------------------
# baseline-config drift gate
# ---------------------------------------------------------------------------
BASELINE_TRANSFORMS = {
    "filter": (
        "--DataXQuery--\n"
        "Hot = SELECT deviceId, temperature FROM DataXProcessedInput "
        "WHERE temperature > 50\n",
        {},
    ),
    "window_agg": (
        "--DataXQuery--\n"
        "WinAgg = SELECT deviceId, COUNT(*) AS Cnt, "
        "AVG(temperature) AS AvgT "
        "FROM DataXProcessedInput_10seconds GROUP BY deviceId\n",
        {"datax.job.process.timewindow.DataXProcessedInput_10seconds"
         ".windowduration": "10 seconds"},
    ),
    "state_join": (
        "--DataXQuery--\n"
        "peaks_in = SELECT deviceId, temperature AS peak "
        "FROM DataXProcessedInput WHERE temperature > 50\n"
        "--DataXQuery--\n"
        "merged = SELECT deviceId, peak FROM peaks_in "
        "UNION ALL SELECT deviceId, peak FROM peaks\n"
        "--DataXQuery--\n"
        "peaks = SELECT deviceId, MAX(peak) AS peak FROM merged "
        "GROUP BY deviceId\n"
        "--DataXQuery--\n"
        "Joined = SELECT a.deviceId, a.temperature, "
        "b.temperature AS prior "
        "FROM DataXProcessedInput a INNER JOIN "
        "DataXProcessedInput_5seconds b ON a.deviceId = b.deviceId "
        "WHERE b.temperature < a.temperature\n",
        {"datax.job.process.timewindow.DataXProcessedInput_5seconds"
         ".windowduration": "5 seconds",
         "datax.job.process.statetable.peaks.schema":
             "deviceId long, peak double"},
    ),
    "fanout_groupby": (
        "--DataXQuery--\n"
        "Fanout = SELECT deviceId, COUNT(*) AS Cnt, "
        "SUM(temperature) AS S FROM DataXProcessedInput "
        "GROUP BY deviceId\n",
        {"datax.job.process.maxgroups": "32"},
    ),
}


def _conf(tmp_path, transform, extra=None, capacity=64, outputs=()):
    d = {
        "datax.job.name": "DevPlan",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": transform,
        "datax.job.process.timestampcolumn": "eventTimeStamp",
        "datax.job.process.watermark": "0 second",
        "datax.job.process.batchcapacity": str(capacity),
    }
    for out in outputs:
        d[f"datax.job.output.{out}.console.maxrows"] = "0"
    d.update(extra or {})
    if "datax.job.process.statetable.peaks.schema" in d:
        d["datax.job.process.statetable.peaks.location"] = str(tmp_path / "state")
    return d


def _outputs(transform):
    return [ln.split("=")[0].strip() for ln in transform.splitlines()
            if "=" in ln and not ln.startswith("--")][-1:]


def _assert_drift_free(proc, jproc=None):
    report = analyze_processor(proc)
    assert report.ok, [d.render() for d in report.errors]
    measured = materialized_stage_bytes(flow_plan_from_processor(proc))
    assert set(measured) == {s.name for s in report.stages}
    for s in report.stages:
        assert s.hbm_bytes == measured[s.name] == s.model_bytes, (
            f"{s.name}: meta {s.hbm_bytes}, real {measured[s.name]}, "
            f"model {s.model_bytes}"
        )
    if jproc is not None:
        jreport = jax_deviceplan.analyze_processor(jproc, chips=1)
        want = {s.name: s for s in jreport.stages}
        assert [s.name for s in report.stages] == list(want)
        for s in report.stages:
            j = want[s.name]
            assert (s.hbm_bytes, s.model_bytes, s.transient_bytes,
                    s.d2h_bytes) == (j.hbm_bytes, j.model_bytes,
                                     j.transient_bytes, j.d2h_bytes), s.name
            assert s.flops == pytest.approx(j.flops, rel=1e-12), s.name
        assert report.totals() == jreport.totals()
    return report


@pytest.mark.parametrize("shape", sorted(BASELINE_TRANSFORMS))
@pytest.mark.parametrize("with_output", [False, True], ids=["plain", "output"])
def test_predicted_bytes_match_materialized(tmp_path, shape, with_output):
    """Per stage, the closed-form model, the meta evaluation and the real
    run agree exactly, and equal the JAX package's numbers (with an
    OUTPUT, its transfer slots and D2H bytes too)."""
    transform, extra = BASELINE_TRANSFORMS[shape]
    outs = _outputs(transform) if with_output else ()
    conf = _conf(tmp_path, transform, extra, outputs=outs)
    proc = FlowProcessor(SettingDictionary(conf), device="cpu")
    jproc = JFlowProcessor(JSettingDictionary(conf))
    report = _assert_drift_free(proc, jproc)
    kinds = {s.kind for s in report.stages}
    assert ("outslot" in kinds) == with_output


def _main_flow_conf(capacity=64):
    conf = chip_smoke.flow_conf()
    conf["datax.job.process.batchcapacity"] = str(capacity)
    conf["datax.job.process.jar.udf.anomalyscore.class"] = (
        "data_accelerator_tpu_torch.udf.samples:anomalyscore"
    )
    for out in chip_smoke.OUTPUTS:
        conf[f"datax.job.output.{out}.console.maxrows"] = "0"
    return conf


def test_main_flow_processor_model_is_exact():
    """The main flow (the alerting flow and the anomaly query) at
    capacity 64: exact per stage, equal to the JAX package's."""
    conf = _main_flow_conf()
    proc = FlowProcessor(SettingDictionary(conf), device="cpu")
    jconf = dict(conf)
    jconf["datax.job.process.jar.udf.anomalyscore.class"] = (
        "data_accelerator_tpu.udf.samples:anomalyscore"
    )
    jproc = JFlowProcessor(JSettingDictionary(jconf))
    report = _assert_drift_free(proc, jproc)
    names = [s.name for s in report.stages]
    for out in chip_smoke.OUTPUTS:
        assert out in names and f"outslot:{out}" in names
    assert report.latency_model()["profileSource"] == "uncalibrated"


def test_persistent_bytes_equal_what_a_streaming_processor_holds():
    """After two batches a processor with sized transfer off holds its
    rings and both A/B slots of every output at full capacity: on the
    CPU, ``device_bytes`` equals the model's persistent bytes."""
    conf = _main_flow_conf()
    conf["datax.job.process.pipeline.sizedtransfer"] = "false"
    proc = FlowProcessor(SettingDictionary(conf), device="cpu")
    rs = np.random.RandomState(3)
    type_ids = np.array(
        [proc.dictionary.encode(t) for t in chip_smoke.DEVICE_TYPES], np.int32
    )
    for b in range(2):
        cols = chip_smoke.make_columns(rs, type_ids, 40)
        proc.process_batch(proc.encode_columns(cols, 40), chip_smoke.BASE_MS + 1000 * b)
    assert proc.device_bytes() == analyze_processor(proc).totals()["persistentBytes"]


def test_output_slots_off_holds_no_slot():
    conf = _main_flow_conf()
    conf["datax.job.process.pipeline.outputslots"] = "false"
    proc = FlowProcessor(SettingDictionary(conf), device="cpu")
    report = analyze_processor(proc)
    assert not [s for s in report.stages if s.kind == "outslot"]
    one = analyze_processor(
        FlowProcessor(SettingDictionary(_main_flow_conf()), device="cpu"),
        output_slots=1,
    )
    assert all(s.detail.startswith("1x") for s in one.stages if s.kind == "outslot")


class DeviceRecorder(TorchDispatchMode):
    """Records the device of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


def test_abstract_eval_produces_no_arrays(tmp_path):
    """--device analysis must not execute: every tensor made while the
    processor's plan is analyzed lies on ``meta``, never in memory."""
    transform, extra = BASELINE_TRANSFORMS["state_join"]
    proc = FlowProcessor(
        SettingDictionary(_conf(tmp_path, transform, extra, outputs=["Joined"])),
        device="cpu",
    )
    with DeviceRecorder() as rec:
        report = analyze_processor(proc)
    assert report.stages and report.ok
    assert rec.ops > 0
    assert rec.devices == {"meta"}


def test_flow_analysis_produces_no_arrays():
    from data_accelerator_tpu_torch.serve.schemainference import infer_schema

    gui = _sampled_gui(infer_schema(_sampled_events()))
    with DeviceRecorder() as rec:
        report = analyze_flow_device(gui)
    assert report.stages
    assert rec.devices <= {"meta"}


@pytest.mark.parametrize("chips", [2, 4])
def test_chips_above_one_are_refused(tmp_path, chips):
    transform, extra = BASELINE_TRANSFORMS["window_agg"]
    proc = FlowProcessor(SettingDictionary(_conf(tmp_path, transform, extra)),
                         device="cpu")
    with pytest.raises(EngineException, match="slice 8"):
        analyze_processor(proc, chips=chips)
    with pytest.raises(EngineException, match="slice 8"):
        analyze_flow_device(_sampled_gui(None), chips=chips)
    assert analyze_processor(proc, chips=1).chips == 1


def _sampled_events():
    return [
        {"site": f"site{i % 8}", "deviceId": i % 40, "temperature": 1.0 * i}
        for i in range(100)
    ]


def _sampled_gui(schema):
    return {
        "name": "sampled",
        "input": {"mode": "streaming", "type": "local", "properties": {
            "inputSchemaFile": json.dumps(schema) if schema else SCHEMA,
            "normalizationSnippet": "Raw.*",
        }},
        "process": {
            "queries": [
                "--DataXQuery--\nAgg = SELECT site, deviceId, COUNT(*) AS c "
                "FROM DataXProcessedInput GROUP BY site, deviceId;\n"
                "OUTPUT Agg TO Metrics;" if schema else
                "--DataXQuery--\nAgg = SELECT deviceId, COUNT(*) AS c "
                "FROM DataXProcessedInput GROUP BY deviceId;\n"
                "OUTPUT Agg TO Metrics;"
            ],
            "jobconfig": {
                "jobBatchCapacity": "1024",
                "maxGroups": "16",
                "stringDictionaryMaxSize": "4",
            },
        },
        "outputs": [{"id": "Metrics", "type": "metric", "properties": {}}],
    }


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sampled_cardinality_feeds_device_lints(pkg):
    """Schema inference records sampled value sets as ``allowedValues``;
    a flow on the inferred schema trips DX200/DX202 when its capacities
    sit below the sampled cardinality, in both packages."""
    if pkg == "jax":
        from data_accelerator_tpu.analysis import analyze_flow_device as afd
        from data_accelerator_tpu.serve.schemainference import infer_schema
        kwargs = {"chips": 1}
    else:
        from data_accelerator_tpu_torch.serve.schemainference import infer_schema
        afd, kwargs = analyze_flow_device, {}
    schema = infer_schema(_sampled_events())
    report = afd(_sampled_gui(schema), **kwargs)
    codes = [d.code for d in report.diagnostics]
    assert "DX200" in codes and "DX202" in codes, codes


def test_armed_processor_analyzes_like_an_unarmed_one():
    conf = _main_flow_conf()
    plain = analyze_processor(FlowProcessor(SettingDictionary(conf), device="cpu"))
    conf.update({
        "datax.job.process.debug.nans": "true",
        "datax.job.process.debug.tracerleaks": "true",
        "datax.job.process.debug.buffersanitizer": "true",
    })
    armed = analyze_processor(FlowProcessor(SettingDictionary(conf), device="cpu"))
    assert armed.to_dict() == plain.to_dict()
