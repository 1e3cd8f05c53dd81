"""Runtime: the per-batch step, window rings and host materialization."""
