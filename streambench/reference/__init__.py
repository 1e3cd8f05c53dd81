"""Plain NumPy references, one a configuration (``<config>.py``), and
what they share (``iot.py``). They import nothing of the program, of
JAX or of the repository's tests."""
