"""The anomaly-score kernel module of the PyTorch port against the JAX
package's Pallas kernel.

The plain PyTorch version (what the port runs on the CPU) is held against
``anomalyscore().fn``, the Pallas kernel run in interpret mode as the JAX
package runs it off the TPU. Tolerance: atol 1e-6 — both compute in
float32, and ``exp`` may differ by an ulp between the two libraries.
"""

import numpy as np
import pytest
import torch

from data_accelerator_tpu.udf.samples import anomalyscore as jax_anomalyscore
from data_accelerator_tpu_torch.kernels import build
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
    out = udf.fn(torch.from_numpy(x), torch.from_numpy(mu))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_anomalyscore().fn(x, mu)), rtol=0, atol=1e-6
    )
    assert udf.launches == 0


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
