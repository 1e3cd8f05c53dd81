"""The bytes the profiled batches' steps must move (``roofline/<config>.py``) at the card's published bandwidth, as a share of their device busy time."""

from streambench import readers


def read(record):
    b = readers.profiled_batches(record)
    if not b:
        return None
    rl = readers.roofline(record)
    n_bytes = sum(rl.step_bytes(record["ref_counts"][x["bt"]]) for x in b)
    return readers.roofline_share(n_bytes, sum(x["busy_s"] for x in b), record)
