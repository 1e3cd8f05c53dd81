"""The bytes ``anomaly_score`` must move for the profiled pass's rows,
at the card's published bandwidth, as a share of the profiled time of
the kernels that compute the score."""

from streambench import readers


def read(record):
    if not readers.on_card(record):
        return None
    p = record["profile"]["pass"]
    rl = readers.roofline(record)
    return readers.roofline_share(rl.anomaly_score_bytes(p["rows"]), p["score_kernel_s"], record)
