"""The batch job's events a second: the events of the window's passes over the time from the window's open to the last pass's end."""

def read(record):
    return record.get("events_per_s")
