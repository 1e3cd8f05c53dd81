"""The program's ``device-step`` span a batch, over the streaming window: on the card, the elapsed time between CUDA events around the step. None on the CPU, and None for a program whose ``device-step`` is still the host interval from dispatch to sync: the card-timed span came with the ``poll`` span, so a window without ``poll`` has the older one."""

from streambench import readers


def read(record):
    if not readers.on_card(record):
        return None
    if not any("poll" in w.get("spans", ()) for w in record.get("window_batches", [])):
        return None
    return readers.stream_spans_ms(record, ("device-step",))
