"""The port's flow analyzer tiers against the JAX package's, on every
golden flow under ``tests/data/flows/``.

Each fixture goes through both packages' semantic tier
(``analyze_flow``), device tier (``analyze_flow_device``, the JAX
package at 1 chip, the port's only chip count) and UDF tier
(``analyze_flow_udfs``), its UDF module paths rewritten to the port's
fixtures and samples as ``tests/test_torch_udfcheck.py`` does:

- semantic: the same diagnostics, field for field (code, severity,
  table, message, span);
- device: the same codes, severities, tables and spans, and per stage
  the same device bytes (meta evaluation vs ``jax.eval_shape``), model
  bytes, transient bytes, D2H bytes and FLOPs; messages are the
  port's own where they speak of the step (DX204, DX290);
- udfs: the same codes, severities and tables; a span points into each
  package's own UDF fixture module, whose lines differ.

Differences on purpose, each asserted as it is:

- ``dx305_udf_pallas``, device tier: the JAX package lowers the bad
  twin's Pallas call under ``jax.eval_shape``, which fails without an
  ``out_shape`` (DX290); the port's meta evaluation runs a kernel UDF's
  plain version (no kernel runs on ``meta``), so the launch hazard is
  the UDF tier's DX305 alone.
- ``dx203_match_matrix_window``, stage ``J``: the residual's transient
  bytes follow the port's block-wise evaluation
  (``costmodel.stage_transient_bytes``).
"""

import json
from pathlib import Path

import pytest

from data_accelerator_tpu.analysis import analyze_flow as jax_analyze_flow
from data_accelerator_tpu.analysis import analyze_flow_device as jax_analyze_flow_device
from data_accelerator_tpu.analysis import analyze_flow_udfs as jax_analyze_flow_udfs
from data_accelerator_tpu.analysis.diagnostics import CODES as JAX_CODES
from data_accelerator_tpu.analysis.diagnostics import (
    REPORT_SCHEMA_VERSION as JAX_REPORT_SCHEMA_VERSION,
)
from data_accelerator_tpu_torch.analysis import (
    CODES,
    REPORT_SCHEMA_VERSION,
    analyze_flow,
    analyze_flow_device,
    analyze_flow_udfs,
)
from data_accelerator_tpu_torch.analysis.costmodel import stage_transient_bytes

ROOT = Path(__file__).resolve().parent.parent
FLOWS = ROOT / "tests" / "data" / "flows"
FIXTURES = sorted(p.stem for p in FLOWS.glob("*.json"))
# device-tier verdicts that differ on purpose (see the module docstring)
DEVICE_VERDICT_DIFFERS = {"dx305_udf_pallas"}
# (fixture, stage) whose transient bytes are the port's own form
TRANSIENT_DIFFERS = {("dx203_match_matrix_window", "J")}


def _to_port(text: str) -> str:
    """A JAX golden flow's module paths -> the port's fixtures/samples."""
    return (
        text.replace("tests.data.udfs.", "tests.data.udfs_torch.")
        .replace("dx305_pallas", "dx305_cuda")
        .replace("data_accelerator_tpu.udf.samples",
                 "data_accelerator_tpu_torch.udf.samples")
    )


def _flows(name):
    text = (FLOWS / f"{name}.json").read_text()
    return json.loads(text), json.loads(_to_port(text))


def _diags(report, fields=("code", "severity", "table", "span")):
    return [{k: v for k, v in d.to_dict().items() if k in fields}
            for d in report.diagnostics]


def test_every_fixture_is_swept():
    assert len(FIXTURES) == 63


def test_code_registry_and_schema_version_equal_the_reference():
    assert REPORT_SCHEMA_VERSION == JAX_REPORT_SCHEMA_VERSION == 5
    assert set(CODES) == set(JAX_CODES)
    assert {c: v[0] for c, v in CODES.items()} == {
        c: v[0] for c, v in JAX_CODES.items()
    }


@pytest.mark.parametrize("name", FIXTURES)
def test_semantic_tier_equals_reference(name):
    jflow, tflow = _flows(name)
    want, got = jax_analyze_flow(jflow), analyze_flow(tflow)
    assert [d.to_dict() for d in got.diagnostics] == [
        d.to_dict() for d in want.diagnostics
    ]
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("name", FIXTURES)
def test_device_tier_equals_reference(name):
    jflow, tflow = _flows(name)
    want = jax_analyze_flow_device(jflow, chips=1)
    got = analyze_flow_device(tflow)
    assert got.chips == 1
    if name in DEVICE_VERDICT_DIFFERS:
        assert [d.code for d in want.diagnostics] == ["DX290"]
        assert got.diagnostics == [] and got.stages
        return
    assert _diags(got) == _diags(want)
    assert got.ok == want.ok
    jst = {s.name: s for s in want.stages}
    assert [s.name for s in got.stages] == [s.name for s in want.stages]
    for s in got.stages:
        j = jst[s.name]
        assert (s.kind, s.rows, s.hbm_bytes, s.model_bytes, s.d2h_bytes) == (
            j.kind, j.rows, j.hbm_bytes, j.model_bytes, j.d2h_bytes
        ), s.name
        assert s.flops == pytest.approx(j.flops, rel=1e-12), s.name
        assert s.ici_bytes == j.ici_bytes == 0.0
        if (name, s.name) in TRANSIENT_DIFFERS:
            assert s.transient_bytes != j.transient_bytes
        else:
            assert s.transient_bytes == j.transient_bytes, s.name
    assert got.outputs == want.outputs


@pytest.mark.parametrize("name", FIXTURES)
def test_udf_tier_equals_reference(name):
    jflow, tflow = _flows(name)
    want, got = jax_analyze_flow_udfs(jflow), analyze_flow_udfs(tflow)
    fields = ("code", "severity", "table")
    assert _diags(got, fields) == _diags(want, fields)
    assert [(u.name, u.tier, bool(u.kind)) for u in got.udfs] == [
        (u.name, u.tier, bool(u.kind)) for u in want.udfs
    ]


def test_residual_transient_is_the_port_form():
    """The one stage whose transient bytes differ: the mask, the
    residual's mask and one block's two gathered operands."""
    from data_accelerator_tpu_torch.ops.join import RESIDUAL_BLOCK_PAIRS

    _jflow, tflow = _flows("dx203_match_matrix_window")
    (j,) = [v for v in _pipeline_views(tflow) if v.name == "J"]
    (site,) = j.plan.joins
    pairs = site.left_rows * site.right_rows
    assert site.has_residual and pairs > RESIDUAL_BLOCK_PAIRS
    assert stage_transient_bytes(j.plan) == 2 * pairs + 8 * RESIDUAL_BLOCK_PAIRS


def _pipeline_views(flow):
    from data_accelerator_tpu_torch.analysis.deviceplan import _plan_from_gui

    plan = _plan_from_gui(flow, [], None)
    return plan.pipeline.views
