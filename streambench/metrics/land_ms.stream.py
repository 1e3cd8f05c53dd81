"""The program's ``collect`` and ``sinks`` spans (fetch, materialise, sink writes) a batch, over the streaming window."""

from streambench import readers


def read(record):
    return readers.stream_spans_ms(record, ("collect", "sinks"))
