"""Hand-written CUDA kernels (sources under ``csrc/``), their build, and
their plain PyTorch versions."""
