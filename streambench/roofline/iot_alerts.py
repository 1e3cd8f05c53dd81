"""The bytes that a batch of ``iot_alerts`` must move on the card, from
the shapes these inputs need, whatever kernels do the work: each input
byte read once and each output byte written once, the window's valid
rows and not its capacity, 4 bytes a value.

- the batch: its ``rows`` events, five fields each (deviceId,
  deviceType, homeId, status, temperature), read once: 20 bytes a row;
- the window: HeatAvg needs deviceId and temperature of each row of the
  window (``window_rows``, this batch's included), read once, and this
  batch's two written into the window state: 8 bytes a window row and 8
  a batch row;
- the outputs: OpenDoors (deviceId, eventTimeStamp) 8 bytes a row,
  AnomalyAlerts (deviceId, score) 8 bytes a row, HeatAvg (deviceId,
  Cnt, AvgT) 12 bytes a group.

``anomaly_score`` reads a temperature and a device id and writes a
score: 12 bytes a scored row, every row of the batch.
"""


def step_bytes(c: dict) -> int:
    return (20 * c["rows"] + 8 * c["rows"] + 8 * c["window_rows"]
            + 8 * c["OpenDoors"] + 8 * c["AnomalyAlerts"] + 12 * c["HeatAvg"])


def anomaly_score_bytes(rows: int) -> int:
    return 12 * rows
