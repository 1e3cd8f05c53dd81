"""The bytes ``anomaly_score`` must move for the profiled batches' rows, at the card's published bandwidth, as a share of the profiled time of the kernels that compute the score."""

from streambench import readers


def read(record):
    b = readers.profiled_batches(record)
    if not b:
        return None
    rl = readers.roofline(record)
    n_bytes = sum(rl.anomaly_score_bytes(record["ref_counts"][x["bt"]]["rows"]) for x in b)
    return readers.roofline_share(n_bytes, sum(x["score_kernel_s"] for x in b), record)
