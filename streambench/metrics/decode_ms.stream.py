"""The program's ``decode`` span (poll and C++ decode) a batch, over the streaming window."""

from streambench import readers


def read(record):
    return readers.stream_spans_ms(record, ("decode",))
