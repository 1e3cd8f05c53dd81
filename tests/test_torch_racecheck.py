"""The port's race tier (``analysis/racecheck.py``, DX80x) against the
JAX package's (``tests/test_racecheck.py``).

- Every golden twin under ``tests/data/race/`` gives the same
  diagnostics (code, severity, span, subject, message) in both tiers,
  and the same marker counts.
- The standing gate: the port's ``runtime/``, ``lq/`` and ``pilot/``
  analyze clean under the port's tier and under the reference's, with
  the port's designed zero-copy and owner-handoff sites pinned.
- The deliberate differences: the torch zero-copy forms
  (``torch.from_numpy``/``as_tensor``/``asarray``/``frombuffer``,
  ``Tensor.numpy``) are DX801 in the port, and its blocking forms
  (``synchronize``, ``.cpu()``, a blocking ``.to()``) DX804; the
  reference's tier sees neither.
- The seeded regression: a ring snapshot that keeps the ring's memory
  instead of a copy fails the port's gate.
"""

import os
import pathlib

import pytest

from data_accelerator_tpu.analysis import racecheck as jrace
from data_accelerator_tpu_torch.analysis import racecheck as trace
from data_accelerator_tpu_torch.analysis.__main__ import main as port_main

HERE = os.path.dirname(__file__)
RACE_DIR = os.path.join(HERE, "data", "race")
FLOWS_DIR = os.path.join(HERE, "data", "flows")
RACE_CODES = ["DX800", "DX801", "DX802", "DX803", "DX804"]
TWINS = [f"{c.lower()}_{k}.py" for c in RACE_CODES for k in ("bad", "clean")]


def _diags(report):
    return [(d.code, d.severity, d.span.line, d.table, d.message)
            for d in report.diagnostics]


@pytest.mark.parametrize("name", TWINS)
def test_golden_twin_diagnostics_equal_reference(name):
    path = os.path.join(RACE_DIR, name)
    jr, tr = jrace.analyze_modules([path]), trace.analyze_modules([path])
    assert _diags(tr) == _diags(jr)
    assert tr.ok == jr.ok == name.endswith("_clean.py")
    assert tr.allowed_zero_copy_sites == jr.allowed_zero_copy_sites
    assert tr.owner_handoff_sites == jr.owner_handoff_sites
    if not tr.ok:
        assert {d.code for d in tr.diagnostics} == {name[:5].upper()}


def test_port_engine_is_race_clean_with_pinned_inventory():
    """The gate over the port's own engine: no finding; the designed
    zero-copy ingest sites (the pool matrix's ``numpy()`` the decoder
    writes through, and ``pack_from_matrix``'s ``from_numpy``) and the
    output slot's handoff to its batch are the only marked sites."""
    paths = trace.engine_module_paths()
    assert trace.ENGINE_PACKAGES == ("runtime", "lq", "pilot")
    assert len(paths) >= 20
    assert all("data_accelerator_tpu_torch" in p for p in paths)
    report = trace.analyze_modules(paths)
    assert report.diagnostics == [], [d.render() for d in report.diagnostics]
    assert report.allowed_zero_copy_sites == 2
    assert report.owner_handoff_sites == 1


def test_reference_tier_finds_nothing_in_the_port_engine():
    """The reference's gate over the port's engine source: its markers
    came over, and ``_advance`` takes the dispatch lock it writes under."""
    report = jrace.analyze_modules(trace.engine_module_paths())
    assert report.diagnostics == [], [d.render() for d in report.diagnostics]


def test_analyze_flow_race_names_the_flow_and_caches():
    r1 = trace.analyze_flow_race({"gui": {"name": "f1"}})
    r2 = trace.analyze_flow_race({"name": "f2"})
    assert r1.ok and r1.flow == "f1" and r2.flow == "f2"
    assert r1.modules is r2.modules
    assert set(r1.race_dict()) == set(jrace.analyze_flow_race({"name": "x"}).race_dict())


TORCH_FORMS = '''
import numpy as np
import torch


class Holder:
    def zero_copy(self):
        ring = self.window_buffers["t"].cols["a"]
        a = torch.from_numpy(ring)
        b = torch.as_tensor(ring)
        c = torch.frombuffer(ring)
        d = ring.numpy()
        e = torch.asarray(ring)
        return None

    def real_copies(self):
        ring = self.window_buffers["t"].cols["a"]
        keep = ring.clone()
        self.kept = keep
        return torch.tensor(ring)

    def dispatch(self, x, stream):
        # dx-race: non-blocking
        stream.synchronize()
        y = x.cpu()
        z = x.to("cpu")
        w = x.to("cuda", non_blocking=True)
        return w
'''


def test_torch_aliasing_and_blocking_forms_are_the_ports_own(tmp_path):
    """Pinned difference: the torch forms are DX801/DX804 in the port and
    invisible to the reference's tier, which knows only ``np.asarray``
    and JAX's blocking calls."""
    p = tmp_path / "forms.py"
    p.write_text(TORCH_FORMS)
    tr, jr = trace.analyze_modules([str(p)]), jrace.analyze_modules([str(p)])
    got = [(d.code, d.span.line) for d in tr.diagnostics]
    lines = TORCH_FORMS.splitlines()

    def line_of(text):
        return next(i for i, t in enumerate(lines, 1) if text in t)

    assert got == sorted(
        [("DX801", line_of(f)) for f in ("from_numpy", "as_tensor(ring)",
                                         "frombuffer", "ring.numpy()",
                                         "torch.asarray")]
        + [("DX804", line_of(f)) for f in ("synchronize", "x.cpu()", 'x.to("cpu")')],
        key=lambda c: (c[1], c[0]))
    assert "DX801" not in {d.code for d in jr.diagnostics}
    assert "DX804" not in {d.code for d in jr.diagnostics}


def _seeded_processor() -> str:
    src = pathlib.Path(trace.__file__).parent.parent.joinpath(
        "runtime", "processor.py").read_text()
    bad = src.replace(
        "{c: self._copy_out(a, stream) for c, a in buf.cols.items()}",
        "{c: a for c, a in buf.cols.items()}",
    ).replace("self._copy_out(buf.valid, stream),", "buf.valid,")
    assert bad != src, "seed target moved: update the regression test"
    return bad


def test_seeded_snapshot_alias_fails_the_gate(tmp_path):
    """A snapshot that hands out the rings' own memory (no copy) is
    caught statically: the returned ``numpy()`` views of the ring."""
    p = tmp_path / "processor.py"
    p.write_text(_seeded_processor())
    report = trace.analyze_modules([str(p)])
    assert not report.ok
    hits = [d for d in report.diagnostics if "snapshot_window_state" in d.message]
    assert {d.code for d in hits} >= {"DX800", "DX801"}


def test_cli_race_exit_and_json(capsys):
    flow = os.path.join(FLOWS_DIR, "clean_config2_window_agg.json")
    assert port_main(["--race", flow]) == 0
    out = capsys.readouterr().out
    assert "race gate" in out
    assert port_main(["--race", "--json", flow]) == 0
    import json

    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["race"]["analyzedFiles"] == len(trace.engine_module_paths())
