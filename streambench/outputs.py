"""Read back what the program's sinks wrote, by the kind of sink the
configuration's ``outputs`` names: ``metric`` rows from the metric
store the metric sink writes to (the one-box Redis stand-in), ``blob``
rows from the JSON(.gz) files the blob sink wrote. Either way the rows
come keyed by the batch time they were written under."""

from __future__ import annotations

import gzip
import json
import re
from collections import defaultdict
from pathlib import Path

# <dataset>_<batch time ms>_<counter>.json[.gz], the blob sink's names
BLOB_NAME = re.compile(r"_(\d+)_(\d+)\.json(\.gz)?$")


def read_blob(folder: Path) -> dict:
    """{batch time ms: [row, ...]} of every file under ``folder``."""
    out = defaultdict(list)
    for p in sorted(Path(folder).rglob("*.json*")):
        m = BLOB_NAME.search(p.name)
        if not m:
            continue
        opener = gzip.open if p.name.endswith(".gz") else open
        with opener(p, "rt", encoding="utf-8") as f:
            lines = [ln for ln in f.read().split("\n") if ln]
        out[int(m.group(1))].extend(json.loads("[" + ",".join(lines) + "]"))
    return dict(out)


def read_metric(store, key: str) -> dict:
    """{batch time ms: [row, ...]} of the rows the metric sink stored
    under ``key`` (scored by batch time)."""
    out = defaultdict(list)
    for score, member in store.zrangebyscore(key, float("-inf"), float("inf")):
        out[int(score)].append(json.loads(member))
    return dict(out)


def read_outputs(config: dict, out_dir: Path, metric_logger=None) -> dict:
    """{dataset: {batch time ms: rows}} for each output of the config."""
    got = {}
    for name, kind in config["outputs"].items():
        if kind == "blob":
            got[name] = read_blob(Path(out_dir) / name)
        elif kind == "metric":
            got[name] = read_metric(metric_logger.store, metric_logger.key(name))
        else:
            raise ValueError(f"output {name}: no reader for sink kind {kind!r}")
    return got
