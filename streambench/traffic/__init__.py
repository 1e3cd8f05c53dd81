"""Traffic: the one generator (``generator.py``) and the mixes it reads
(``<mix>.json``)."""
