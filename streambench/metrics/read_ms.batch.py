"""The program's ``read`` span around each ``read_json_file`` call, a chunk, over the batch window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("read" in w.get("spans", ()) for w in record.get("window_passes", [])):
        return None
    return readers.batch_spans_ms(record, ("read",))
