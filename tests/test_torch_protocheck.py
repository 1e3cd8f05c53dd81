"""The port's protocol tier (``analysis/protocheck.py``, DX90x) against
the JAX package's (``tests/test_protocheck.py``).

- Every golden twin under ``tests/data/proto/`` gives the same
  diagnostics (code, severity, span, subject, message) and marker
  counts in both tiers.
- The standing gate: the port's ``runtime/``, ``lq/`` and ``pilot/``
  hold the delivery protocol under the port's tier and the
  reference's, with the effect inventory pinned.
- The trim: no rescale-handoff module rides along until the control
  plane (``serve/jobs.py``, slice 9) is ported.
"""

import json
import os

import pytest

from data_accelerator_tpu.analysis import protocheck as jproto
from data_accelerator_tpu_torch.analysis import protocheck as tproto
from data_accelerator_tpu_torch.analysis.__main__ import main as port_main

HERE = os.path.dirname(__file__)
PROTO_DIR = os.path.join(HERE, "data", "proto")
FLOWS_DIR = os.path.join(HERE, "data", "flows")
PROTO_CODES = ["DX900", "DX901", "DX902", "DX903", "DX904", "DX905"]
TWINS = [f"{c.lower()}_{k}.py" for c in PROTO_CODES for k in ("bad", "clean")]


def _diags(report):
    return [(d.code, d.severity, d.span.line, d.table, d.message)
            for d in report.diagnostics]


@pytest.mark.parametrize("name", TWINS)
def test_golden_twin_diagnostics_equal_reference(name):
    path = os.path.join(PROTO_DIR, name)
    jr = jproto.analyze_proto_modules([path])
    tr = tproto.analyze_proto_modules([path])
    assert _diags(tr) == _diags(jr)
    assert tr.ok == jr.ok == name.endswith("_clean.py")
    assert tr.protocol_dict()["effectEvents"] == jr.protocol_dict()["effectEvents"]
    assert tr.post_commit_sites == jr.post_commit_sites
    assert tr.requeue_upstream_sites == jr.requeue_upstream_sites


def test_port_engine_is_protocol_clean_with_pinned_inventory():
    paths = tproto.proto_module_paths()
    report = tproto.analyze_proto_modules(paths)
    assert report.ok and report.diagnostics == [], [d.render() for d in report.diagnostics]
    pd = report.protocol_dict()
    assert pd["analyzedFiles"] == len(paths) >= 24
    assert pd["effectEvents"] == 28
    assert pd["postCommitSites"] == 3
    assert pd["requeueUpstreamSites"] == 1
    rels = {m["path"] for m in pd["modules"]}
    assert "runtime/host.py" in rels and "runtime/statetable.py" in rels


def test_rescale_handoff_module_waits_for_the_control_plane():
    """Pinned trim: the reference covers ``serve/jobs.py`` too; the port
    has no such module yet, so its gate is the engine alone."""
    assert tproto.PROTO_EXTRA_MODULES == ()
    assert jproto.PROTO_EXTRA_MODULES == (os.path.join("serve", "jobs.py"),)
    assert tproto.proto_module_paths() == tproto.engine_module_paths()


def test_reference_tier_finds_nothing_in_the_port_engine():
    report = jproto.analyze_proto_modules(tproto.proto_module_paths())
    assert report.diagnostics == []
    assert report.protocol_dict()["effectEvents"] == 28


def test_cli_protocol_exit_and_json(capsys):
    flow = os.path.join(FLOWS_DIR, "clean_config2_window_agg.json")
    assert port_main(["--protocol", flow]) == 0
    out = capsys.readouterr().out
    assert "protocol gate:" in out and "engine module(s) analyzed" in out
    assert port_main(["--protocol", "--json", flow]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["protocol"]["analyzedFiles"] >= 24
