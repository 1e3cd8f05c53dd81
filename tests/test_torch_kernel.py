"""The anomaly-score kernel module of the PyTorch port against the JAX
package's Pallas kernel.

The plain PyTorch version (what the port runs on the CPU) is held against
``anomalyscore().fn``, the Pallas kernel run in interpret mode as the JAX
package runs it off the TPU. Tolerance: atol 1e-6 — both compute in
float32, and ``exp`` may differ by an ulp between the two libraries.
"""

import types

import numpy as np
import pytest
import torch

from data_accelerator_tpu.udf.samples import anomalyscore as jax_anomalyscore
from data_accelerator_tpu_torch.kernels import build, launch, timing
from data_accelerator_tpu_torch.kernels.anomaly_score import (
    AnomalyScoreKernel,
    anomaly_score_plain,
)
from data_accelerator_tpu_torch.udf import CudaKernelUdf
from data_accelerator_tpu_torch.udf.samples import anomalyscore

torch.set_num_threads(2)


def _inputs(n, mu_dtype, seed):
    """Random rows plus the two edges: x == mu (score 0.5) and far
    outliers (score -> 1)."""
    rs = np.random.RandomState(seed)
    mu = rs.randint(-8, 9, n).astype(mu_dtype)
    x = rs.uniform(-100, 100, n).astype(np.float32)
    x[::3] = mu[::3]
    x[1::7] = 1e6
    x[2::11] = -1e7
    return x, mu


@pytest.mark.parametrize("n", [1, 1023, 1025, 4099])
@pytest.mark.parametrize("mu_dtype", [np.int32, np.float32])
def test_plain_matches_pallas_kernel(n, mu_dtype):
    x, mu = _inputs(n, mu_dtype, seed=n)
    ref = np.asarray(jax_anomalyscore().fn(x, mu))
    got = anomaly_score_plain(torch.from_numpy(x), torch.from_numpy(mu))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    at_mu = x == mu.astype(np.float32)
    assert at_mu.any() and np.all(got.numpy()[at_mu] == 0.5)


def test_udf_on_cpu_tensors_uses_plain_version_without_launching():
    udf = anomalyscore()
    assert isinstance(udf, CudaKernelUdf)
    x, mu = _inputs(1025, np.int32, seed=7)
    launch.reset_launches()
    out = udf.fn(torch.from_numpy(x), torch.from_numpy(mu))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_anomalyscore().fn(x, mu)), rtol=0, atol=1e-6
    )
    assert udf.launches == 0 and launch.launches("anomaly_score") == 0


def test_wrapper_refuses_cpu_tensors():
    kernel = AnomalyScoreKernel()
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        kernel(x, x)
    assert kernel.launches == 0


def test_library_path_follows_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    first = build.library_path("k")
    assert first == build.library_path("k")
    assert first.parent == tmp_path / "_build"
    src.write_text("// b\n")
    assert build.library_path("k") != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    src.write_text("// a\n")
    assert build.library_path("k") != first


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPKfPfl' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPKfPfl
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compile time = 3.141 ms
ptxas info    : Compiling entry function '_Z4tilePKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z4tilePKfPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4096 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_resources_are_read_per_kernel():
    assert build.parse_ptxas(PTXAS_LOG) == [
        {"kernel": "_Z6kernelPKfPfl", "registers": 14, "smem_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0},
        {"kernel": "_Z4tilePKfPf", "registers": 255, "smem_bytes": 4096,
         "spill_store_bytes": 4, "spill_load_bytes": 12},
    ]
    assert build.parse_ptxas("") == []
    assert ("-Xptxas", "-v") == build.NVCC_FLAGS[-2:]


def test_stream_lookup_raises_where_torch_has_none(monkeypatch):
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA stream lookup"):
        launch.current_stream(0)


def test_launch_switches_device_only_when_it_differs(monkeypatch):
    entered = []

    class Switch:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(launch, "current_stream", lambda index: 100 + index)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Switch)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    assert launch.run_on_device(0, entry, 7, 8) == 0
    assert entered == [] and calls == [(7, 8, 100)]
    launch.run_on_device(1, entry, 9)
    assert entered == [1] and calls[-1] == (9, 101)


def test_kernel_builds_the_source_it_was_given(monkeypatch, tmp_path):
    loaded = []

    def entry(*args):
        return 0

    def load(source):
        loaded.append(source)
        return types.SimpleNamespace(dx_anomaly_score=entry)

    monkeypatch.setattr(build, "load", load)
    earlier = tmp_path / "anomaly_score.cu"
    assert AnomalyScoreKernel()._entry() is entry
    assert AnomalyScoreKernel(earlier)._entry() is entry
    assert loaded == ["anomaly_score", earlier]


def test_timing_cli_needs_a_directory_and_a_card(monkeypatch, capsys):
    assert timing.DX305_SOURCE.is_file()
    assert timing.main([]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main(["earlier"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, 262144])
@pytest.mark.parametrize("mu_dtype", [np.int32, np.float32])
def test_kernel_matches_plain_on_card(cuda_device, n, mu_dtype):
    x, mu = _inputs(n, mu_dtype, seed=n)
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(mu).to(cuda_device)
    kernel = AnomalyScoreKernel()
    got = kernel(xt, mt)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    ref = anomaly_score_plain(xt, mt)
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_empty_input_launches_nothing_on_card(cuda_device):
    x = torch.empty(0, dtype=torch.float32, device=cuda_device)
    mu = torch.empty(0, dtype=torch.int32, device=cuda_device)
    kernel = AnomalyScoreKernel()
    got = kernel(x, mu)
    assert got.shape == (0,) and got.dtype == torch.float32
    assert kernel.launches == 0


def _card_rows(n, dtype, offset, seed, device):
    """``_inputs``-style rows as a view ``offset`` rows into its
    allocation on the card, so that its start is 4*offset bytes past a
    16-byte boundary."""
    rs = np.random.RandomState(seed)
    if dtype is np.float32:
        base = rs.uniform(-100, 100, n + offset).astype(np.float32)
        base[1::7] = 1e6
    else:
        base = rs.randint(-8, 9, n + offset).astype(np.int32)
    return torch.from_numpy(base).to(device)[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5, 1023, 1025])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("x_dtype,mu_dtype", [
    (np.float32, np.int32), (np.float32, np.float32),
    (np.int32, np.int32), (np.int32, np.float32),
])
def test_kernel_matches_plain_at_views_and_tails_on_card(
        cuda_device, n, offset, x_dtype, mu_dtype):
    # x and mu start 4*offset and 4*(3 - offset) bytes past a 16-byte
    # boundary: both off it by different amounts, or one on it (offsets
    # 0 and 3), so one loads 16-byte vectors and the other row by row
    x = _card_rows(n, x_dtype, offset, n, cuda_device)
    mu = _card_rows(n, mu_dtype, 3 - offset, n + 1, cuda_device)
    kernel = AnomalyScoreKernel()
    got = kernel(x, mu)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert float((got - anomaly_score_plain(x, mu)).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_kernel_in_cuda_graph_replays_as_a_direct_call(cuda_device):
    x = _card_rows(262144, np.float32, 0, 3, cuda_device)
    mu = _card_rows(262144, np.int32, 0, 4, cuda_device)
    kernel = AnomalyScoreKernel()
    direct = kernel(x, mu)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel(x, mu)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, direct)
    x.add_(1.5)  # the graph reads its inputs where they lie
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, kernel(x, mu))
    # one count for the call, one for the capture; a replay is not a call
    assert kernel.launches == 3


@pytest.mark.cuda
def test_launch_count_follows_calls_through_the_udf_on_card(cuda_device):
    udf = anomalyscore()
    x = _card_rows(1025, np.float32, 1, 5, cuda_device)
    mu = _card_rows(1025, np.int32, 0, 6, cuda_device)
    launch.reset_launches()
    for _ in range(5):
        udf.fn(x, mu)
    with pytest.raises(TypeError, match="float32 or int32"):
        udf.fn(x.double(), mu)
    udf.fn(x[:0], mu[:0])
    torch.cuda.synchronize()
    assert udf.launches == 5 and launch.launches("anomaly_score") == 5


@pytest.mark.cuda
def test_entry_refuses_an_output_off_a_16_byte_boundary_on_card(cuda_device):
    x = _card_rows(1025, np.float32, 0, 8, cuda_device)
    mu = _card_rows(1025, np.int32, 0, 9, cuda_device)
    out = torch.full((1028,), float("nan"), device=cuda_device)
    entry = AnomalyScoreKernel()._entry()
    stream = launch.current_stream(torch.cuda.current_device())
    for off in (1, 2, 3):
        rc = entry(x.data_ptr(), 0, mu.data_ptr(), 1, out[off:].data_ptr(),
                   1025, stream)
        assert rc != 0
    torch.cuda.synchronize()
    assert bool(out.isnan().all())  # refused before any launch
    assert entry(x.data_ptr(), 0, mu.data_ptr(), 1, out.data_ptr(), 1025,
                 stream) == 0
    torch.cuda.synchronize()
    assert float((out[:1025] - anomaly_score_plain(x, mu)).abs().max()) <= 1e-6
