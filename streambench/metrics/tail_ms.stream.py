"""The program's ``tail`` span a batch (after the source's ack: metrics, alerts, the fleet publisher, the log line, the checkpoint), over the streaming window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("tail" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("tail",))
