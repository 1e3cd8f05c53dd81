"""Seconds from the process's start to the window's first measured event."""

def read(record):
    return record.get("setup_s")
