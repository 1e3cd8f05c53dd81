"""1 - the card's busy time over the profiled pass's wall time."""

from streambench import readers


def read(record):
    if not readers.on_card(record):
        return None
    p = record["profile"]["pass"]
    return 1.0 - p["busy_s"] / p["host_s"] if p["host_s"] > 0 else None
