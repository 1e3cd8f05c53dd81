"""The anomaly-score kernel (``csrc/anomaly_score.cu``) and its plain
PyTorch version.

Replaces ``data_accelerator_tpu/udf/samples.py::_anomaly_kernel``, the
Pallas kernel that ``PallasUdf._pallas_call`` launches. The plain version
repeats the kernel's arithmetic on any device; the CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .build import Source
from .launch import DTYPE_CODES as _DTYPE_CODES
from .launch import count_launch, run_on_device

SOURCE = "csrc/anomaly_score.cu"


def anomaly_score_plain(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-|x - mu| / (1 + |mu|)))`` in float32."""
    x = x.to(torch.float32)
    mu = mu.to(torch.float32)
    d = torch.abs(x - mu) / (1.0 + torch.abs(mu))
    return 1.0 / (1.0 + torch.exp(-d))


class AnomalyScoreKernel:
    """Launches the CUDA kernel on CUDA tensors; counts its launches, in
    ``launches`` and in the process-wide ``launch.launches(name)``.

    Takes float32 or int32 ``x`` and ``mu`` of one length, contiguous, on
    one CUDA device, and raises on anything else. Launches on the current
    stream and does not synchronise. ``source`` is the kernel's ``.cu``
    file (``kernels/timing.py`` times an earlier version of it)."""

    name = "anomaly_score"

    def __init__(self, source: Source = "anomaly_score"):
        self.launches = 0
        self._source = source
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = build.load(self._source).dx_anomaly_score
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        codes = []
        for t, what in ((x, "x"), (mu, "mu")):
            if not t.is_cuda:
                raise ValueError(f"anomaly_score: {what} is not a CUDA tensor")
            code = _DTYPE_CODES.get(t.dtype)
            if code is None:
                raise TypeError(
                    f"anomaly_score: {what} has dtype {t.dtype}; the kernel "
                    "takes float32 or int32"
                )
            if t.dim() != 1 or not t.is_contiguous():
                raise ValueError(
                    f"anomaly_score: {what} must be a contiguous 1-D tensor"
                )
            codes.append(code)
        n = x.numel()
        if mu.numel() != n:  # both 1-D: their shapes differ
            raise ValueError(
                f"anomaly_score: size mismatch {tuple(x.shape)} vs "
                f"{tuple(mu.shape)}"
            )
        index = x.get_device()
        if mu.get_device() != index:
            raise ValueError(
                f"anomaly_score: inputs on {x.device} and {mu.device}"
            )
        out = torch.empty_like(x, dtype=torch.float32)
        if n == 0:
            return out  # nothing to launch, so nothing to count
        rc = run_on_device(
            index, self._entry(), x.data_ptr(), codes[0], mu.data_ptr(),
            codes[1], out.data_ptr(), n,
        )
        if rc != 0:
            raise RuntimeError(f"anomaly_score launch failed: CUDA error {rc}")
        self.launches += 1
        count_launch(self.name)
        return out
