"""The program's ``decode`` span (``encode_rows``) a chunk, over the batch window."""

from streambench import readers


def read(record):
    return readers.batch_spans_ms(record, ("decode",))
