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
from .launch import DTYPE_CODES as _DTYPE_CODES

SOURCE = "csrc/anomaly_score.cu"


def anomaly_score_plain(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-|x - mu| / (1 + |mu|)))`` in float32."""
    x = x.to(torch.float32)
    mu = mu.to(torch.float32)
    d = torch.abs(x - mu) / (1.0 + torch.abs(mu))
    return 1.0 / (1.0 + torch.exp(-d))


class AnomalyScoreKernel:
    """Launches the CUDA kernel on CUDA tensors; counts its launches.

    Takes float32 or int32 ``x`` and ``mu`` of one length, contiguous, on
    one CUDA device, and raises on anything else. Launches on the current
    stream and does not synchronise."""

    name = "anomaly_score"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = build.load("anomaly_score").dx_anomaly_score
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        for t, what in ((x, "x"), (mu, "mu")):
            if t.device.type != "cuda":
                raise ValueError(f"anomaly_score: {what} is not a CUDA tensor")
            if t.dtype not in _DTYPE_CODES:
                raise TypeError(
                    f"anomaly_score: {what} has dtype {t.dtype}; the kernel "
                    "takes float32 or int32"
                )
            if t.dim() != 1 or not t.is_contiguous():
                raise ValueError(
                    f"anomaly_score: {what} must be a contiguous 1-D tensor"
                )
        if x.shape != mu.shape:
            raise ValueError(
                f"anomaly_score: size mismatch {tuple(x.shape)} vs "
                f"{tuple(mu.shape)}"
            )
        if x.device != mu.device:
            raise ValueError(
                f"anomaly_score: inputs on {x.device} and {mu.device}"
            )
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        if x.numel() == 0:
            return out  # nothing to launch, so nothing to count
        entry = self._entry()
        # the launch goes to the current device's context
        with torch.cuda.device(x.device):
            rc = entry(
                x.data_ptr(), _DTYPE_CODES[x.dtype],
                mu.data_ptr(), _DTYPE_CODES[mu.dtype],
                out.data_ptr(), x.numel(),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"anomaly_score launch failed: CUDA error {rc}")
        self.launches += 1
        return out
