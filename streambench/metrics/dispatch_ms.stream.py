"""The program's ``dispatch`` span (the enqueue of the step's launches) a batch, over the streaming window."""

from streambench import readers


def read(record):
    return readers.stream_spans_ms(record, ("dispatch",))
