"""The share of the window GROUP BY's sort that is real rows: the program's counters ``Group_RowsInWindow`` over ``Group_RowsScanned`` (the ring rows sorted), summed over the streaming window's batches, as the program's metric sink stored them by batch time. None where the program keeps no such counter."""


def _points(store, name: str) -> dict:
    """{batch time ms: value} of every flow's counter ``name``."""
    out = {}
    for key in store.keys():
        if key.endswith(":" + name):
            for p in store.points(key):
                out[int(p["uts"])] = float(p["val"])
    return out


def read(record):
    batches = record.get("window_batches", [])
    if not batches:
        return None
    from data_accelerator_tpu_torch.obs.store import METRIC_STORE

    scanned = _points(METRIC_STORE, "Group_RowsScanned")
    in_window = _points(METRIC_STORE, "Group_RowsInWindow")
    bts = [w["bt"] for w in batches if w["bt"] in scanned and w["bt"] in in_window]
    total = sum(scanned[bt] for bt in bts)
    return sum(in_window[bt] for bt in bts) / total if total > 0 else None
