"""The median latency of the events due in the streaming window: from the moment the open loop was due to send an event to the ack of the batch that consumed it."""

import numpy as np


def read(record):
    lat = record.get("latencies_ms")
    return float(np.percentile(lat, 50)) if lat is not None and lat.size else None
