"""The program's ``poll`` span a batch (the socket source's drain and join of its buffered lines, inside ``decode``), over the streaming window. None where the program records no such span."""

from streambench import readers


def read(record):
    if not any("poll" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("poll",))
