"""The bytes that a batch of ``fleet_rollup`` must move on the card,
from the shapes these inputs need, whatever kernels do the work: each
input byte read once and each output byte written once, the window's
valid rows and not its ring's capacity, 4 bytes a value.

- the batch: its ``rows`` events, five fields each (deviceId,
  deviceType, homeId, status, temperature), read once: 20 bytes a row;
- the window's GROUP BY (``group_bytes``): deviceId and temperature of
  each row of the window (``window_rows``, this batch's included), read
  once, 8 bytes a row, and per group formed (``groups``) its count, sum,
  maximum and key written once, 16 bytes a group;
- the output: HotDevices (deviceId, Cnt, AvgT, MaxT), 16 bytes a row.
"""


def group_bytes(c: dict) -> int:
    return 8 * c["window_rows"] + 16 * c["groups"]


def step_bytes(c: dict) -> int:
    return 20 * c["rows"] + group_bytes(c) + 16 * c["HotDevices"]
