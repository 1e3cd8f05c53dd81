"""1 - the card's busy time over the profiled batches' host time, poll to ack (the pacing sleep excluded)."""

from streambench import readers


def read(record):
    b = readers.profiled_batches(record)
    host = sum(x["host_s"] for x in b)
    return 1.0 - sum(x["busy_s"] for x in b) / host if b and host > 0 else None
