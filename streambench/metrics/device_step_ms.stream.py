"""The card's busy time a batch: the union of kernel, copy and memset intervals between a profiled batch's poll and its ack, from the benchmark's profiler window."""

from streambench import readers


def read(record):
    b = readers.profiled_batches(record)
    return 1e3 * sum(x["busy_s"] for x in b) / len(b) if b else None
