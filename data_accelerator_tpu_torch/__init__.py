"""PyTorch/CUDA port of the data_accelerator_tpu streaming engine."""
