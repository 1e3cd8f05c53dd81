"""The 95th percentile of the same latencies: what alerting users feel."""

import numpy as np


def read(record):
    lat = record.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat is not None and lat.size else None
