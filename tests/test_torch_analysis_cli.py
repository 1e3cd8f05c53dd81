"""The port's analysis CLI (``python -m data_accelerator_tpu_torch.analysis``)
against the JAX package's, over clean and bad golden fixtures.

Both ``main`` functions run in this process on the same flow files
(their UDF module paths rewritten to the port's fixtures, as in
``tests/test_torch_analysis.py``). For the ported tiers (semantic,
``--device``, ``--udfs`` and the port's ``--all``, which is those
three) the exit codes are equal, and so are the ``--json`` reports
once the fields that differ by design are set aside: the device block's
``latencyModel`` (the JAX package prices under a TPU datasheet, the
port reports ``uncalibrated``), an output slot stage's detail (the
JAX package's slots are donated buffers, the port's are not), a UDF
diagnostic's message and span and
a function's module path (each package's own fixture module), and the
DX204/DX290 messages (the port's step has no trace), and the
transient bytes of the residual join of ``dx203_match_matrix_window``
(the port's own form). The JAX package
runs its device tier at ``--chips=1``. The text mode prints the same
diagnostic lines for the semantic tier.

The tiers not ported yet exit 2 and name their slice; ``--chips`` above
1 exits 2 naming slice 8; an unknown flag and a missing file exit 2 as
in the reference.
"""

import json
from pathlib import Path

import pytest

from data_accelerator_tpu.analysis.__main__ import main as jax_main
from data_accelerator_tpu_torch.analysis.__main__ import UNPORTED_FLAGS
from data_accelerator_tpu_torch.analysis.__main__ import main as port_main

ROOT = Path(__file__).resolve().parent.parent
FLOWS = ROOT / "tests" / "data" / "flows"
CLEAN = ["clean_config2_window_agg", "clean_config3_state_join",
         "clean_config4_udf_rules", "clean_config5_fanout_groupby",
         "clean_multisource_window_join"]
BAD = ["dx001_unbound_table", "dx010_type_mismatch", "dx200_group_capacity",
       "dx203_match_matrix_window", "dx204_retrace_hazard",
       "dx290_device_lowering", "dx291_unloadable_udf", "dx300_udf_branch",
       "dx303_udf_stale", "dx310_udf_unloadable"]
TIERS = {
    "semantic": ([], []),
    "device": (["--device"], ["--device", "--chips=1"]),
    "udfs": (["--udfs"], ["--udfs"]),
    "all": (["--all"], ["--device", "--chips=1", "--udfs"]),
}
# the residual join's transient bytes are the port's own form
# (tests/test_torch_analysis.py)
TRANSIENT_DIFFERS = {"dx203_match_matrix_window"}
UDF_CODES = ("DX30", "DX31")
REWORDED = ("DX204", "DX290")


def _to_port(text: str) -> str:
    return (
        text.replace("tests.data.udfs.", "tests.data.udfs_torch.")
        .replace("dx305_pallas", "dx305_cuda")
        .replace("data_accelerator_tpu.udf.samples",
                 "data_accelerator_tpu_torch.udf.samples")
    )


def _files(tmp_path, name):
    text = (FLOWS / f"{name}.json").read_text()
    jpath, tpath = tmp_path / f"jax_{name}.json", tmp_path / f"port_{name}.json"
    jpath.write_text(text)
    tpath.write_text(_to_port(text))
    return str(jpath), str(tpath)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _comparable(report: dict, transients: bool = True) -> dict:
    r = json.loads(json.dumps(report))
    r.pop("file", None)
    for d in r["diagnostics"]:
        if d["code"].startswith(UDF_CODES):
            d.pop("message"), d.pop("span")
        elif d["code"] in REWORDED:
            d.pop("message")
    if "device" in r:
        r["device"].pop("latencyModel")
        for st in r["device"]["stages"]:
            if st["kind"] == "outslot":
                st.pop("detail")  # the JAX package's slots are donated
            if not transients:
                st.pop("transientBytes")
        if not transients:
            r["device"]["totals"].pop("transientBytes")
    if "udfs" in r:
        for f in r["udfs"]["functions"]:
            f.pop("path"), f.pop("kind")
    return r


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", CLEAN + BAD)
def test_json_report_and_exit_code_equal_reference(tmp_path, capsys, name, tier):
    port_flags, jax_flags = TIERS[tier]
    jpath, tpath = _files(tmp_path, name)
    jrc, jout, _ = _run(jax_main, ["--json", *jax_flags, jpath], capsys)
    trc, tout, terr = _run(port_main, ["--json", *port_flags, tpath], capsys)
    assert trc == jrc, (name, tier, terr)
    if name in CLEAN:
        assert trc == 0
    got, want = json.loads(tout), json.loads(jout)
    transients = name not in TRANSIENT_DIFFERS or "device" not in got
    if not transients:
        assert (got["device"]["totals"]["transientBytes"]
                != want["device"]["totals"]["transientBytes"])
    assert _comparable(got, transients) == _comparable(want, transients)
    if tier == "all":
        assert "not ported yet" in terr


@pytest.mark.parametrize("name", ["dx001_unbound_table", "dx007_duplicate_alias",
                                  "clean_config2_window_agg"])
def test_text_mode_prints_the_same_semantic_lines(tmp_path, capsys, name):
    jpath, tpath = _files(tmp_path, name)
    jrc, jout, _ = _run(jax_main, [jpath], capsys)
    trc, tout, _ = _run(port_main, [tpath], capsys)
    assert trc == jrc
    assert tout.replace(tpath, "F") == jout.replace(jpath, "F")


def test_device_text_mode_prints_the_plan(tmp_path, capsys):
    _jpath, tpath = _files(tmp_path, "clean_config2_window_agg")
    rc, out, _ = _run(port_main, ["--device", tpath], capsys)
    assert rc == 0
    assert "device plan (1 card)" in out
    assert "roofline latency: uncalibrated" in out


@pytest.mark.parametrize("flag", sorted(UNPORTED_FLAGS) + [
    "--manifest=m.json", "--manifest-out=m.json", "--fleet-spec=s.json"])
def test_unported_tier_flags_exit_2_naming_their_slice(tmp_path, capsys, flag):
    _jpath, tpath = _files(tmp_path, "clean_config2_window_agg")
    rc, out, err = _run(port_main, [flag, tpath], capsys)
    assert rc == 2 and out == ""
    assert "not ported" in err
    assert ("slice 8" if flag == "--mesh" else "slice 7b") in err


def test_chips_above_one_exit_2_naming_slice_8(tmp_path, capsys):
    _jpath, tpath = _files(tmp_path, "clean_config2_window_agg")
    rc, _out, err = _run(port_main, ["--device", "--chips=4", tpath], capsys)
    assert rc == 2 and "slice 8" in err
    rc, _out, err = _run(port_main, ["--device", "--chips=0", tpath], capsys)
    assert rc == 2 and "chip count" in err


@pytest.mark.parametrize("argv", [[], ["--devcie", "x.json"], ["missing.json"]])
def test_usage_and_io_errors_exit_2_as_in_the_reference(tmp_path, capsys, argv):
    argv = [str(tmp_path / a) if a.endswith(".json") else a for a in argv]
    jrc, _o, _e = _run(jax_main, argv, capsys)
    trc, _o, _e = _run(port_main, argv, capsys)
    assert trc == jrc == 2
