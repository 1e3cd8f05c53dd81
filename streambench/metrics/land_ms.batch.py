"""The program's ``collect`` and ``sinks`` spans a chunk, over the batch window."""

from streambench import readers


def read(record):
    return readers.batch_spans_ms(record, ("collect", "sinks"))
