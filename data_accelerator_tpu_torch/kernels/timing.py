"""Device timers for the kernels, and their comparison with an earlier
version of their sources on one card.

    python -m data_accelerator_tpu_torch.kernels.timing DIR

DIR holds an earlier ``anomaly_score.cu`` and ``dx305_double.cu`` with the
same C entry points as this tree's, for example taken from git by::

    git show REV:data_accelerator_tpu_torch/csrc/anomaly_score.cu > DIR/anomaly_score.cu
    git show REV:tests/data/udfs_torch/dx305_double.cu > DIR/dx305_double.cu

Each source is built through ``build.load`` by its path. For each kernel
the two versions' outputs must be equal; then each version's device time
at ``N`` and ``N_LARGE`` rows is taken in turns (earlier, this, this,
earlier), one JSON line a kernel. Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .build import PACKAGE_DIR

# the main path's batch, and 64 x it: beyond the 50 MB L2 for both kernels
N = 262_144
N_LARGE = 16_777_216
DX305_SOURCE = PACKAGE_DIR.parent / "tests" / "data" / "udfs_torch" / "dx305_double.cu"


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of per-run CUDA-event times, each run one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed, timed with CUDA events; the median replay over ``reps``.
    Unlike ``cuda_ms`` this leaves out the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture, as graph capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, runs=10, warmup=1) / reps


def compare(directory: Path) -> None:
    """One JSON line a kernel: the earlier sources in ``directory``
    against this tree's, device time in turns at ``N`` and ``N_LARGE``."""
    from .anomaly_score import AnomalyScoreKernel
    from .launch import cuda_call

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(N, device=dev, generator=gen) * 100
    mu = torch.randint(1, 9, (N,), dtype=torch.int32, device=dev, generator=gen)
    xl = torch.rand(N_LARGE, device=dev, generator=gen) * 100
    mul = torch.randint(1, 9, (N_LARGE,), dtype=torch.int32, device=dev,
                        generator=gen)

    def dx305(source):
        return lambda t: cuda_call(source, "dx305_double", t, out_shape=t.shape)

    earlier_a = AnomalyScoreKernel(directory / "anomaly_score.cu")
    this_a = AnomalyScoreKernel()
    earlier_d, this_d = dx305(directory / "dx305_double.cu"), dx305(DX305_SOURCE)
    versions = {
        "anomaly_score": (
            (lambda: earlier_a(x, mu), lambda: earlier_a(xl, mul)),
            (lambda: this_a(x, mu), lambda: this_a(xl, mul))),
        "dx305_double": (
            (lambda: earlier_d(x), lambda: earlier_d(xl)),
            (lambda: this_d(x), lambda: this_d(xl))),
    }
    for name, (earlier, this) in versions.items():
        if not torch.equal(earlier[0](), this[0]()):
            raise AssertionError(f"{name}: the two versions disagree")
        turns = []
        for who, (small, large) in (("earlier", earlier), ("this", this),
                                    ("this", this), ("earlier", earlier)):
            turns.append({"version": who, "device_ms": graph_ms(small),
                          "device_ms_large": graph_ms(large, reps=10)})
        print(json.dumps({"phase": "compare", "name": name, "n": N,
                          "n_large": N_LARGE, "turns": turns}), flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    compare(Path(args[0]).resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
