"""What the per-metric readers (``metrics/<name>.py``) share. A reader
returns None where its run has nothing for it to read (an untraced run,
a CPU rehearsal, a card missing from ``peaks.json``), never a 0 for a
share of a roofline."""

from __future__ import annotations

from typing import Iterable, Optional

from streambench.harness import load_module


def stream_spans_ms(record: dict, names: Iterable[str]) -> Optional[float]:
    """The streaming window's span time of ``names`` a batch: the total
    over the window's batches over their count."""
    batches = [b for b in record.get("window_batches", []) if "spans" in b]
    if not batches:
        return None
    return sum(b["spans"][n] for b in batches for n in names) / len(batches)


def batch_spans_ms(record: dict, names: Iterable[str]) -> Optional[float]:
    """The batch window's span time of ``names`` a chunk: the total over
    the window's passes over their chunks."""
    passes = [p for p in record.get("window_passes", []) if "spans" in p]
    chunks = sum(len(p["chunks"]) for p in passes)
    if not chunks:
        return None
    return sum(p["spans"][n] for p in passes for n in names) / chunks


def on_card(record: dict) -> bool:
    """A device number comes from a run on the card, never the CPU."""
    return record["device"]["platform"] == "gpu" and bool(record.get("profile"))


def profiled_batches(record: dict) -> list:
    return record["profile"].get("batches", []) if on_card(record) else []


def roofline_share(n_bytes: float, seconds: float, record: dict) -> Optional[float]:
    """The least time the bytes take at the card's published bandwidth,
    as a percentage of ``seconds``."""
    peaks = record.get("peaks")
    if not peaks or seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / peaks["hbm_bytes_per_s"] / seconds


def roofline(record: dict):
    return load_module("roofline", record["config"])
