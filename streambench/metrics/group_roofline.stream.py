"""The bytes the window's GROUP BYs must move (``roofline/<config>.py``'s ``group_bytes``) at the card's published bandwidth, as a share of their ``window-group`` spans' card time, over the streaming window. None on the CPU, where a configuration counts no group bytes, and where the program records no such span."""

from streambench import readers


def read(record):
    if not readers.on_card(record):
        return None
    rl = readers.roofline(record)
    if not hasattr(rl, "group_bytes"):
        return None
    batches = [w for w in record.get("window_batches", []) if "window-group" in w.get("spans", ())]
    if not batches:
        return None
    n_bytes = sum(rl.group_bytes(record["ref_counts"][w["bt"]]) for w in batches)
    ms = sum(w["spans"]["window-group"] for w in batches)
    return readers.roofline_share(n_bytes, ms / 1e3, record)
