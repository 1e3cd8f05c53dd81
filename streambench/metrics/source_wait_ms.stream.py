"""The program's ``source/wait`` span a batch (from the arrival stamp of the batch's oldest line to the poll that drained it), over the streaming window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("source/wait" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("source/wait",))
