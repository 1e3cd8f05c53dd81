"""The program's ``sink/file/write`` span a chunk (the blob sinks' gzip and atomic write), over the batch window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("sink/file/write" in w.get("spans", ()) for w in record.get("window_passes", [])):
        return None
    return readers.batch_spans_ms(record, ("sink/file/write",))
