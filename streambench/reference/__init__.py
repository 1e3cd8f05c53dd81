"""Plain references, one a configuration (``<config>.py``), in NumPy or
in PyTorch on the CPU, and what they share (``iot.py``). They import
nothing of the program, of JAX or of the repository's tests; one that
imports torch turns TF32 off when it is imported and names the device
of every tensor it builds (``harness.py`` states the contract)."""
