"""The program's ``sink/file/encode`` span a batch (the blob sink's rows to JSON text), over the streaming window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("sink/file/encode" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("sink/file/encode",))
