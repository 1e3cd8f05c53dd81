"""The program's ``sink/file/write`` span a batch (the blob sink's gzip and atomic write), over the streaming window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("sink/file/write" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("sink/file/write",))
