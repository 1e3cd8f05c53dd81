"""The benchmark of the PyTorch/CUDA port (``data_accelerator_tpu_torch``).

``python3 streambench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON result line. Cells, configurations, traffic mixes,
loops, per-layer metric readers, plain references and roofline counts
are files found by name (``harness.py``); this package imports nothing
heavy, so the traffic generator's process can import its modules.
"""
