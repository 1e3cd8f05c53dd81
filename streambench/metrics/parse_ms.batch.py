"""The benchmark's own ``parse`` span around each ``read_json_file`` call, a chunk, over the batch window."""

from streambench import readers


def read(record):
    return readers.batch_spans_ms(record, ("parse",))
