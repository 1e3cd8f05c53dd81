"""The PyTorch port's user-kernel UDF path and its UDF analyzer tier
against the JAX package.

- Kernel parity: the DX305 fixture's kernel, ``o = float32(x) * 2``,
  through the JAX fixture (its Pallas kernel in interpret mode, as the
  JAX package runs it off the TPU) and the port's twin (its plain
  version, as the port runs on the CPU): equal exactly, since a cast and
  a multiply by 2 round the same in both.
- Flow parity: the same UDF declared in each package's flow conf, the
  same batches through both ``FlowProcessor``s: ints exact, floats
  within rtol 1e-6.
- Analyzer parity: each golden flow of the JAX analyzer tier, its module
  paths rewritten to the port's fixtures and samples, gives the same
  (code, severity) list through the port's ``analyze_flow_udfs``; every
  clean twin and shipped sample gives none.
- Ground truth: what each code warns of really happens to the bad twin
  (a host read seen by a ``TorchFunctionMode``, a ``TypeError``, a
  truncated column, a fake aggregate) and not to the clean one.
- ``cuda_call``'s refusals, and the kernel on the card (``cuda`` marker).
"""

import json
import stat
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from data_accelerator_tpu.analysis import analyze_flow_udfs as jax_analyze_flow_udfs
from data_accelerator_tpu.core.config import SettingDictionary as JSettingDictionary
from data_accelerator_tpu.runtime.processor import FlowProcessor as JFlowProcessor
from data_accelerator_tpu_torch.analysis import analyze_flow_udfs, check_udf_object
from data_accelerator_tpu_torch.core.config import EngineException, SettingDictionary
from data_accelerator_tpu_torch.kernels import build, launch
from data_accelerator_tpu_torch.kernels.launch import cuda_call
from data_accelerator_tpu_torch.runtime.processor import FlowProcessor
from data_accelerator_tpu_torch.udf.api import CudaKernelUdf, load_udfs_from_conf
# the fixture packages by the path the JAX package's tests use (tests/
# is on sys.path under pytest); flow confs name them from the repo root
from data.udfs import dx305_pallas as jax_dx305
from data.udfs_torch import (
    dx300_branch,
    dx301_hostsync,
    dx302_impure,
    dx303_stale,
    dx304_outtype,
    dx305_cuda,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FLOWS = ROOT / "tests" / "data" / "flows"
GOLDEN = [
    "dx300_udf_branch", "dx301_udf_hostsync", "dx302_udf_impure",
    "dx303_udf_stale", "dx304_udf_outtype", "dx305_udf_pallas",
    "dx310_udf_unloadable", "clean_config4_udf_rules",
]
SCHEMA = json.dumps({
    "type": "struct",
    "fields": [
        {"name": "deviceId", "type": "long", "nullable": False, "metadata": {}},
        {"name": "temperature", "type": "double", "nullable": False,
         "metadata": {}},
    ],
})
X = torch.arange(1.0, 9.0)
SYNC_CALLS = {"__bool__", "__int__", "__float__", "item", "tolist", "cpu",
              "numpy"}


def _to_port(text: str) -> str:
    """A JAX golden flow's module paths -> the port's fixtures/samples."""
    return (
        text.replace("tests.data.udfs.", "tests.data.udfs_torch.")
        .replace("dx305_pallas", "dx305_cuda")
        .replace("data_accelerator_tpu.udf.samples",
                 "data_accelerator_tpu_torch.udf.samples")
    )


def _rows(n, dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype is np.int32:
        return rs.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    x = rs.uniform(-1e6, 1e6, n).astype(np.float32)
    x[::7] = np.float32(3.4e38)  # doubles to inf in both
    return x


class SyncRecorder(TorchFunctionMode):
    """Records the tensor calls that read a tensor back to the host."""

    def __init__(self):
        super().__init__()
        self.syncs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in SYNC_CALLS:
            self.syncs.append(name)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# kernel and flow parity with the JAX fixture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 1023, 1025, 4099])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dx305_plain_matches_pallas_fixture(n, dtype):
    x = _rows(n, dtype, seed=n)
    ref = np.asarray(jax_dx305.clean().fn(jnp.asarray(x)))
    udf = dx305_cuda.clean()
    assert isinstance(udf, CudaKernelUdf)
    got = udf.fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), ref)


def _flow_conf(udf_class, capacity=64):
    return {
        "datax.job.name": "UserKernelUdf",
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": (
            "--DataXQuery--\n"
            "S = SELECT deviceId, pdouble(temperature) AS p "
            "FROM DataXProcessedInput"
        ),
        "datax.job.process.projection": "Raw.*",
        "datax.job.process.jar.udf.pdouble.class": udf_class,
    }


def test_conf_declared_user_kernel_flow_matches_jax():
    cap = 64
    jproc = JFlowProcessor(
        JSettingDictionary(_flow_conf("tests.data.udfs.dx305_pallas:clean")),
        batch_capacity=cap, output_datasets=["S"],
    )
    tproc = FlowProcessor(
        SettingDictionary(_flow_conf("tests.data.udfs_torch.dx305_cuda:clean")),
        batch_capacity=cap, output_datasets=["S"], device="cpu",
    )
    assert isinstance(tproc.udfs["pdouble"], CudaKernelUdf)
    rs = np.random.RandomState(305)
    for b, n in enumerate([cap, 17, 0, 40]):
        cols = {
            "deviceId": rs.randint(1, 9, cap).astype(np.int32),
            "temperature": np.round(rs.uniform(-50, 150, cap), 3).astype(np.float32),
        }
        t = 1_700_000_000_000 + 1000 * b
        jrows = jproc.process_batch(jproc.encode_columns(cols, n), batch_time_ms=t)[0]["S"]
        trows = tproc.process_batch(tproc.encode_columns(cols, n), batch_time_ms=t)[0]["S"]
        assert len(trows) == len(jrows) == n
        for jr, tr in zip(jrows, trows):
            assert tr["deviceId"] == jr["deviceId"]
            np.testing.assert_allclose(tr["p"], jr["p"], rtol=1e-6)
    assert tproc.udfs["pdouble"].kernel.__qualname__ == "_clean_kernel"


# ---------------------------------------------------------------------------
# analyzer parity on the golden flows, clean twins and samples
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flow", GOLDEN)
def test_analyzer_matches_jax_on_golden_flow(flow):
    text = (FLOWS / f"{flow}.json").read_text()
    jax_report = jax_analyze_flow_udfs(json.loads(text))
    report = analyze_flow_udfs(json.loads(_to_port(text)))
    assert [(d.code, d.severity) for d in report.diagnostics] == [
        (d.code, d.severity) for d in jax_report.diagnostics
    ]
    # one device function walked per UDF on both sides; the port's DX305
    # UDF is a CudaKernelUdf, so its launcher is the "kernel" role where
    # the JAX fixture's pallas_call sits in "fn"
    assert [len(u.analyzed) for u in report.udfs] == [
        len(u.analyzed) for u in jax_report.udfs
    ]
    if not flow.startswith("clean"):
        assert report.diagnostics, f"{flow}: the bad twin went unflagged"
    assert report.to_dict()["errorCount"] == len(jax_report.errors)


@pytest.mark.parametrize("flow", GOLDEN[:-1])
def test_clean_twin_has_no_diagnostics(flow):
    text = _to_port((FLOWS / f"{flow}.json").read_text())
    assert ":bad" in text
    report = analyze_flow_udfs(json.loads(text.replace(":bad", ":clean")))
    assert report.diagnostics == [], [d.render() for d in report.diagnostics]
    assert report.ok


def test_port_samples_pass_the_analyzer():
    from data_accelerator_tpu_torch.udf.samples import (
        HelloWorldUdf,
        anomalyscore,
        lastabove,
        scaleby,
    )

    for make_udf in (scaleby, lastabove, anomalyscore, HelloWorldUdf):
        diags, _roles = check_udf_object(make_udf())
        assert diags == [], [d.render() for d in diags]
    # the tiers with a device function were walked, not skipped
    assert check_udf_object(scaleby())[1] == ["fn"]
    assert check_udf_object(lastabove())[1] == ["reduce"]
    assert check_udf_object(anomalyscore())[1] == ["kernel"]
    assert check_udf_object(HelloWorldUdf())[1] == []


def test_dx305_read_back_feeding_the_grid_is_reported_once():
    diags, roles = check_udf_object(dx305_cuda.bad())
    assert roles == ["kernel"]
    assert sorted(d.code for d in diags) == ["DX305", "DX305"]
    assert any("grid=" in d.message for d in diags)
    assert any("without out_shape" in d.message for d in diags)


# ---------------------------------------------------------------------------
# ground truth: each code's hazard really happens to the bad twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mod,sync", [
    (dx300_branch, "__bool__"),
    (dx301_hostsync, "__float__"),
])
def test_bad_twin_reads_back_and_clean_twin_does_not(mod, sync):
    with SyncRecorder() as rec:
        bad_out = mod.bad().fn(X)
    assert sync in rec.syncs
    with SyncRecorder() as rec:
        clean_out = mod.clean().fn(X)
    assert rec.syncs == []
    torch.testing.assert_close(clean_out, bad_out, rtol=0, atol=0)


def test_dx302_side_effect_repeats_every_batch():
    dx302_impure.CALLS.clear()
    bad = dx302_impure.bad()
    for _ in range(3):
        bad.fn(X)
    # eager PyTorch: three batches, three appends (the JAX package runs
    # the append once, at trace time)
    assert len(dx302_impure.CALLS) == 3
    dx302_impure.CALLS.clear()
    torch.testing.assert_close(dx302_impure.clean().fn(X), X * 2.0)
    assert dx302_impure.CALLS == []


def test_dx303_state_update_lands_mid_stream():
    udf = dx303_stale.bad()
    cells = dict(zip(udf.fn.__code__.co_freevars, udf.fn.__closure__))
    state = cells["state"].cell_contents
    torch.testing.assert_close(udf.fn(X), X * 2.0)
    state["factor"] = 5.0  # no on_interval: nobody marks the change
    torch.testing.assert_close(udf.fn(X), X * 5.0)
    clean = dx303_stale.clean()
    assert clean.on_interval(0) is False


def _make_proc(transform, udfs=None, conf_extra=None, capacity=64):
    conf = {
        "datax.job.name": "UdfCheckRt",
        "datax.job.input.default.inputtype": "local",
        "datax.job.input.default.blobschemafile": SCHEMA,
        "datax.job.process.transform": transform,
        "datax.job.process.projection": "Raw.*",
    }
    conf.update(conf_extra or {})
    return FlowProcessor(
        SettingDictionary(conf), udfs=udfs, batch_capacity=capacity,
        output_datasets=["T"], device="cpu",
    )


def _feed(proc, device_ids, temps, batch_time_ms=1_700_000_000_000):
    cap = proc.batch_capacity
    cols = {
        "deviceId": np.zeros(cap, np.int32),
        "temperature": np.zeros(cap, np.float32),
    }
    n = len(device_ids)
    cols["deviceId"][:n] = device_ids
    cols["temperature"][:n] = temps
    raw = proc.encode_columns(cols, n)
    return proc.process_batch(raw, batch_time_ms=batch_time_ms)


@pytest.mark.parametrize("attr,expected", [("bad", 2), ("clean", 2.5)])
def test_dx304_declared_type_decodes_the_column(attr, expected):
    proc = _make_proc(
        "--DataXQuery--\n"
        "T = SELECT halfit(temperature) AS h FROM DataXProcessedInput",
        udfs={"halfit": getattr(dx304_outtype, attr)()},
    )
    datasets, _ = _feed(proc, [1], [5.0])
    assert float(dx304_outtype._half(torch.tensor([5.0]))[0]) == 2.5
    # declared long: the 2.5 the function computes decodes as 2
    assert datasets["T"][0]["h"] == expected
    assert type(datasets["T"][0]["h"]) is type(expected)


def test_dx305_bad_twin_reads_grid_then_misses_out_shape():
    bad = dx305_cuda.bad()
    with SyncRecorder() as rec:
        with pytest.raises(TypeError, match="out_shape"):
            bad.kernel(X)
    assert rec.syncs == ["__int__"]
    # the plain version on the CPU is what both twins run here
    torch.testing.assert_close(bad.fn(X), X * 2.0)


def test_dx305_clean_twin_refuses_cpu_tensors_without_reading_them():
    launch.reset_launches()
    clean = dx305_cuda.clean()
    with SyncRecorder() as rec:
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            clean.kernel(X)
        out = clean.fn(X)
    assert rec.syncs == []
    torch.testing.assert_close(out, X * 2.0)
    assert launch.launches("dx305_double") == 0


class TestDX310GroundTruth:
    Q = (
        "--DataXQuery--\n"
        "T = SELECT deviceId, lastval(temperature) AS l "
        "FROM DataXProcessedInput GROUP BY deviceId"
    )

    def _run(self, attr):
        proc = _make_proc(self.Q, conf_extra={
            "datax.job.process.jar.udaf.lastval.class":
                f"tests.data.udfs_torch.dx310_notaggregate:{attr}",
        })
        datasets, _ = _feed(proc, [1, 1, 2], [3.0, 9.0, 5.0])
        return {r["deviceId"]: r["l"] for r in datasets["T"]}

    def test_bad_silently_does_not_aggregate(self):
        # group 1 holds {3.0, 9.0}; the fake aggregate returns the
        # first row's value instead of the max — silent wrong answers
        assert self._run("bad") == {1: 3.0, 2: 5.0}

    def test_clean_twin_aggregates(self):
        assert self._run("clean") == {1: 9.0, 2: 5.0}

    def test_unloadable_conf_entry_raises(self):
        with pytest.raises(EngineException):
            load_udfs_from_conf(SettingDictionary({
                "datax.job.process.jar.udf.ghost.class":
                    "tests.data.udfs_torch.no_such_module:bad",
            }))


# ---------------------------------------------------------------------------
# cuda_call's refusals (before any build) and the build of a user source
# ---------------------------------------------------------------------------
SRC = dx305_cuda.SOURCE
ENTRY = dx305_cuda.ENTRY


@pytest.mark.parametrize("call,error,match", [
    (lambda x: cuda_call(SRC, ENTRY, x), TypeError, "out_shape"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=(x[0],)), TypeError,
     "Python ints"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=x.shape, grid=(x[0],)),
     TypeError, "Python ints"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=x.shape, grid=(2, 2)),
     ValueError, "block count"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=x.shape, grid=0),
     ValueError, "block count"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=x.shape,
                         out_dtype=torch.float64), TypeError, "out_dtype"),
    (lambda x: cuda_call(SRC, ENTRY, out_shape=(8,)), ValueError,
     "at least one input"),
    (lambda x: cuda_call(SRC, ENTRY, x.double(), out_shape=x.shape),
     TypeError, "dtype"),
    (lambda x: cuda_call(SRC, ENTRY, x[::2], out_shape=(4,)), ValueError,
     "contiguous"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=(9,)), ValueError,
     "elements"),
    (lambda x: cuda_call(SRC, ENTRY, x, out_shape=x.shape), ValueError,
     "not a CUDA tensor"),
])
def test_cuda_call_refuses_before_building(call, error, match, monkeypatch):
    def no_build(source):
        raise AssertionError("cuda_call built a kernel it should refuse")

    monkeypatch.setattr(build, "load", no_build)
    launch.reset_launches()
    with pytest.raises(error, match=match):
        call(X.clone())
    assert launch.launches(ENTRY) == 0


def test_source_path_takes_names_and_paths(tmp_path):
    assert build.source_path("anomaly_score") == build.CSRC_DIR / "anomaly_score.cu"
    assert build.source_path(SRC) == SRC.resolve()
    assert build.source_path(str(SRC)) == SRC.resolve()
    with pytest.raises(build.KernelBuildError, match=r"\.cu"):
        build.source_path(tmp_path / "kernel.cpp")
    with pytest.raises(build.KernelBuildError, match="cannot read"):
        build.library_path(tmp_path / "missing.cu")


def test_library_is_keyed_on_path_contents_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    a = tmp_path / "a" / "k.cu"
    b = tmp_path / "b" / "k.cu"
    for p in (a, b):
        p.parent.mkdir()
        p.write_text("// same\n")
    first = build.library_path(a)
    assert first == build.library_path(str(a))
    assert first.parent == tmp_path / "_build"
    assert first.name.startswith("libk-")
    assert build.library_path(b) != first  # same text, another path
    a.write_text("// edited\n")
    assert build.library_path(a) != first


def _fake_nvcc(tmp_path, script):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return str(nvcc)


def test_nvcc_error_on_user_source_is_a_build_error(tmp_path, monkeypatch):
    src = tmp_path / "user.cu"
    src.write_text("this is not CUDA\n")
    nvcc = _fake_nvcc(tmp_path, 'echo "user.cu(1): error: bad source"; exit 2\n')
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(build.KernelBuildError, match="error: bad source"):
        build.load(src)
    assert not list((tmp_path / "_build").iterdir())


def test_missing_entry_symbol_is_a_build_error(tmp_path, monkeypatch):
    import ctypes

    monkeypatch.setattr(build, "load", lambda source: ctypes.CDLL(None))
    with pytest.raises(build.KernelBuildError, match="no symbol 'dx_absent'"):
        launch._entry(tmp_path / "user.cu", "dx_absent")


def test_build_runs_nvcc_once_for_each_source(tmp_path, monkeypatch):
    log = tmp_path / "calls"
    # a stand-in compiler: records its call, writes the -o file
    nvcc = _fake_nvcc(
        tmp_path,
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = -o ]; then touch "$2"; fi; '
        "shift; done\n",
    )
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    srcs = []
    for name in ("one", "two"):
        srcs.append(tmp_path / f"{name}.cu")
        srcs[-1].write_text(f"// {name}\n")
    paths = build.build(srcs)
    assert [p.exists() for p in paths] == [True, True]
    assert build.build(srcs) == paths  # built already: nvcc not run again
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, 262144])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dx305_kernel_matches_plain_on_card(cuda_device, n, dtype):
    x = torch.from_numpy(_rows(n, dtype, seed=n)).to(cuda_device)
    launch.reset_launches()
    got = dx305_cuda.clean().fn(x)
    torch.cuda.synchronize()
    assert launch.launches(ENTRY) == 1
    assert torch.equal(got, dx305_cuda.double_plain(x))


@pytest.mark.cuda
def test_cuda_call_on_card_grid_count_and_refusals(cuda_device):
    x = torch.arange(-5000, 5000, dtype=torch.int32, device=cuda_device)
    launch.reset_launches()
    for grid in (None, 1, (3,), 4096):
        got = cuda_call(SRC, ENTRY, x, out_shape=x.shape, grid=grid)
        assert torch.equal(got, dx305_cuda.double_plain(x))
    empty = cuda_call(SRC, ENTRY, x[:0], out_shape=(0,))
    assert empty.shape == (0,)
    torch.cuda.synchronize()
    assert launch.launches(ENTRY) == 4
    with pytest.raises(TypeError, match="dtype"):
        cuda_call(SRC, ENTRY, x.double(), out_shape=x.shape)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_call(SRC, ENTRY, x[::2], out_shape=(x.numel() // 2,))
    with pytest.raises(RuntimeError, match="CUDA error"):
        # the kernel takes float32 output only and says so
        cuda_call(SRC, ENTRY, x, out_shape=x.shape, out_dtype=torch.int32)
    assert launch.launches(ENTRY) == 4


@pytest.mark.cuda
def test_bad_twins_raise_under_sync_debug_error(cuda_device):
    x = X.to(cuda_device)
    for mod in (dx300_branch, dx301_hostsync, dx305_cuda):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with pytest.raises(RuntimeError, match="synchroniz"):
                mod.bad().fn(x)
            out = mod.clean().fn(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(out.cpu(), mod.clean().fn(X))
