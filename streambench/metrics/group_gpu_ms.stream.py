"""The program's ``window-group`` spans a batch (each GROUP BY over a time window, on the card the elapsed time between CUDA events around its launches), over the streaming window. None on the CPU, and None where the program records no such span."""

from streambench import readers


def read(record):
    if not readers.on_card(record):
        return None
    if not any("window-group" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("window-group",))
