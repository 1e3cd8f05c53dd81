# golden-fixture UDF modules of the PyTorch port's DX3xx analyzer tier:
# the torch twin of each tests/data/udfs module, one per code, each with
# a `bad` factory (the flagged pattern) and a `clean` twin (same job,
# sync-free and pure). The UDF names match the JAX fixtures, so one
# golden flow reads the same for both. tests/test_torch_udfcheck.py pairs
# every analyzer verdict with a runtime ground-truth test over these.
