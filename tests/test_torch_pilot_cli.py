"""The port's pilot replay CLI (``python -m data_accelerator_tpu_torch.pilot
--replay``) against the JAX package's on the same recordings: the
reference's ``TestReplayCli`` cases, each run through both ``main``
functions with equal exit codes and equal output (text and ``--json``),
and a recording a piloted drill of the port's host wrote."""

import json

import pytest

import chip_smoke
from data_accelerator_tpu.pilot.__main__ import main as jax_main
from data_accelerator_tpu_torch.pilot.__main__ import main as port_main
from data_accelerator_tpu_torch.pilot.controller import SignalSnapshot
from data_accelerator_tpu_torch.serve.scenarios import DrillFlow


def _write_trace(path, records):
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _evaluate_span(now, **props):
    base = SignalSnapshot(now=now).to_props()
    base.update(props)
    return {"type": "span", "name": "pilot/evaluate", "trace": "t", "span": "s",
            "parent": None, "startTs": now, "durationMs": 0.1, "properties": base}


def _both(argv, capsys):
    jrc = jax_main(list(argv))
    jout = capsys.readouterr()
    trc = port_main(list(argv))
    tout = capsys.readouterr()
    assert trc == jrc
    return trc, tout.out, jout.out, tout.err, jout.err


RECORDINGS = {
    "recorded": [
        {"type": "event", "name": "noise"},
        _evaluate_span(100.0, stall_ms=900.0, depth=4),
        _evaluate_span(200.0, stall_ms=10.0, depth=3, saturation=1.0),
    ],
    "flip": [
        _evaluate_span(100.0, stall_ms=900.0, depth=4),
        _evaluate_span(130.0, stall_ms=10.0, depth=3, saturation=1.0),
    ],
    "sync-spans": [
        {"type": "span", "name": "sync", "startTs": 100.0 + i,
         "durationMs": 800.0, "properties": {}} for i in range(12)
    ],
}
FLAGS = [[], ["--json"], ["--json", "--cooldown", "60"],
         ["--window", "5", "--budget", "1", "--max-depth", "2"]]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "text")
@pytest.mark.parametrize("name", sorted(RECORDINGS))
def test_replay_prints_the_reference_decisions(tmp_path, capsys, name, flags):
    trace = tmp_path / "trace.jsonl"
    _write_trace(trace, RECORDINGS[name])
    rc, tout, jout, _te, _je = _both(["--replay", str(trace), *flags], capsys)
    assert rc == 0
    assert tout == jout
    if "--json" in flags:
        doc = json.loads(tout)
        assert doc["snapshots"] == ("reconstructed" if name == "sync-spans" else "recorded")


def test_cooldown_override_holds_the_reversal(tmp_path, capsys):
    trace = tmp_path / "trace.jsonl"
    _write_trace(trace, RECORDINGS["flip"])
    _rc, out, _j, _te, _je = _both(["--replay", str(trace), "--json", "--cooldown", "60"],
                                   capsys)
    doc = json.loads(out)
    assert doc["actuations"] == 1
    assert doc["evaluations"][1]["decisions"][0]["suppressed"] == "cooldown"


def test_replay_of_a_piloted_drill_recording(tmp_path, capsys):
    """A hot-key-skew drill of the port's host, pilot on, records its
    ``pilot/evaluate`` spans; both CLIs replay them, under the default
    knobs, to the same decisions."""
    ctx = chip_smoke.run_chaos_drill("hot-key-skew", True, str(tmp_path),
                                     DrillFlow(device="cpu"))
    rc, tout, jout, _te, _je = _both(["--replay", ctx["tracefile"], "--json"], capsys)
    assert rc == 0 and tout == jout
    doc = json.loads(tout)
    assert doc["snapshots"] == "recorded" and doc["evaluations"]


@pytest.mark.parametrize("argv,rc", [
    (["--repaly", "x.jsonl"], 2), ([], 2),
    (["--replay", "/nonexistent/trace.jsonl"], 1),
])
def test_usage_and_missing_file_exit_as_the_reference(capsys, argv, rc):
    got, tout, jout, terr, jerr = _both(argv, capsys)
    assert got == rc
    assert tout == jout
    assert terr.replace("data_accelerator_tpu_torch", "data_accelerator_tpu") == jerr
